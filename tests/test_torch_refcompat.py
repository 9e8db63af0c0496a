"""The port's reference-format module (``cammiq_tpu_torch/index/refcompat.py``)
against its source, ``cammiq_tpu/index/refcompat.py``: byte-identical
``.bin``/``.aux`` files from both writers, each package reading the other's
files, the hand-derived bytes of ``tests/test_refcompat_fixture.py``, equal
``FlatIndex`` arrays from ``reference_index_to_flat``, and bit-identical
counts from query sessions on the imported tables, for both engines."""

import numpy as np
import pytest
import torch

import cammiq_tpu.index.refcompat as jrc
from cammiq_tpu.config import BuildConfig
from cammiq_tpu.config import QueryConfig as JQueryConfig
from cammiq_tpu.index.builder import build_index
from cammiq_tpu.io.fasta import corpus_from_sequences
from cammiq_tpu.query.pipeline import QuerySession as JaxSession
import cammiq_tpu_torch.index.refcompat as trc
from cammiq_tpu_torch.config import QueryConfig
from cammiq_tpu_torch.index.table import FlatIndex
from cammiq_tpu_torch.query.pipeline import QuerySession
from torch_fixture import ALPHA, by_entry_key, pair_genomes, pair_reads

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

PKG = {"port": trc, "jax": jrc}
KINDS = ("unique", "doubly")
CFG = dict(k=12, L=60, Lmax=30, h=12, mode="both")
FLAT_FIELDS = ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2",
               "table_lo", "table_hi", "table_start", "table_count")
FLAT_STATICS = ("h", "kw", "max_probes", "max_bucket", "is_doubly")
COUNT_FIELDS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d")

# Copied verbatim from tests/test_refcompat_fixture.py, whose docstring
# derives them by hand from the reference encoder's definition.
AUX_U = bytes([0x40, 0x05, 0x86, 0x11, 0x03] + [0xFF] * 8)
INT_U = (
    (108).to_bytes(8, "big")
    + (7).to_bytes(4, "big") + (3).to_bytes(2, "big")
    + (682).to_bytes(8, "big")
    + (2).to_bytes(4, "big") + (1).to_bytes(2, "big")
    + (5).to_bytes(4, "big") + (9).to_bytes(2, "big")
    + b"\xff" * 8 + b"\xff\xff"
)
AUX_D = bytes([0xC0, 0x05, 0x87] + [0xFF] * 9)
INT_D = (
    (108).to_bytes(8, "big")
    + (3).to_bytes(4, "big") + (11).to_bytes(4, "big")
    + (2).to_bytes(2, "big") + (6).to_bytes(2, "big")
    + b"\xff" * 8 + b"\xff\xff"
)
FIXTURE = {
    "unique": (INT_U, AUX_U, False,
               [("ACGTA", 7, 0, 3, 0), ("GGGGGA", 2, 0, 1, 0),
                ("GGGGGCT", 5, 0, 9, 0)]),
    "doubly": (INT_D, AUX_D, True, [("ACGTA", 3, 11, 2, 6)]),
}


@pytest.fixture(scope="module")
def ref_art():
    """The small corpus of tests/test_refcompat.py: 4 genomes sharing one
    120-base segment, built by the JAX package's numpy engine."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 4, 120)
    genomes = []
    for _ in range(4):
        own = rng.integers(0, 4, 400)
        ins = int(rng.integers(0, 280))
        genomes.append([ALPHA[np.concatenate([own[:ins], shared, own[ins:]])].tobytes()])
    return build_index(corpus_from_sequences(genomes), BuildConfig(**CFG),
                       engine="numpy")


@pytest.fixture(scope="module")
def pair_art():
    """5 genomes x 600 bases with a segment planted in each pair of
    neighbours, so the doubly table has entries and sc mode pair counts;
    and the genomes, for reads."""
    gs, planted = pair_genomes(21, ng=5, glen=600, seg=120)
    art = build_index(corpus_from_sequences([[ALPHA[x].tobytes()] for x in gs]),
                      BuildConfig(**CFG), engine="numpy")
    return art, gs, planted


def _index(art, kind):
    return art.unique_index if kind == "unique" else art.doubly_index


def _canon(ix):
    """The entry set: sorted (key words, length, rid1, rid2, ucount1,
    ucount2) rows, as tests/test_refcompat.py compares them."""
    return sorted(
        (tuple(int(w) for w in ix.key_words[e]), int(ix.length[e]),
         int(ix.rid1[e]), int(ix.rid2[e]), int(ix.ucount1[e]), int(ix.ucount2[e]))
        for e in range(ix.num_entries))


def _write(tmp_path, who, idx, name):
    p = str(tmp_path / name)
    PKG[who].write_reference_index(p, idx)
    return p


def _files(p):
    with open(p, "rb") as a, open(p + ".aux", "rb") as b:
        return a.read(), b.read()


@pytest.mark.parametrize("corpus", ["refcompat", "pairs"])
@pytest.mark.parametrize("kind", KINDS)
def test_writers_byte_identical(ref_art, pair_art, tmp_path, corpus, kind):
    idx = _index(ref_art if corpus == "refcompat" else pair_art[0], kind)
    assert idx.num_entries > 0
    got = _files(_write(tmp_path, "port", idx, "port.bin"))
    want = _files(_write(tmp_path, "jax", idx, "jax.bin"))
    assert got == want


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_each_reads_the_others_files(pair_art, tmp_path, writer, kind):
    idx = _index(pair_art[0], kind)
    p = _write(tmp_path, writer, idx, f"index.{kind}.bin")
    reader = PKG["jax" if writer == "port" else "port"]
    back = reader.reference_index_to_flat(p, Lmax=30)
    assert (back.h, back.is_doubly, back.num_entries) == (
        idx.h, idx.is_doubly, idx.num_entries)
    assert _canon(back) == _canon(idx)


def _decoded(entries):
    return sorted(
        ("".join(ALPHA[np.asarray(c)].tobytes().decode()), int(r1), int(r2),
         int(u1), int(u2))
        for c, r1, r2, u1, u2 in zip(entries["codes"], entries["rid1"],
                                     entries["rid2"], entries["uc1"], entries["uc2"]))


@pytest.mark.parametrize("kind", KINDS)
def test_port_decodes_hand_derived_bytes(tmp_path, kind):
    main, aux, doubly, want = FIXTURE[kind]
    p = tmp_path / f"fixture.{kind}.bin"
    p.write_bytes(main)
    (tmp_path / f"fixture.{kind}.bin.aux").write_bytes(aux)
    entries, h, is_doubly = trc.read_reference_index(str(p))
    assert (h, is_doubly) == (5, doubly)
    assert _decoded(entries) == want
    for name in ("rid1", "rid2", "uc1", "uc2"):
        assert entries[name].dtype == np.int64
    # re-encoded by the port: the same entries; the one-bucket doubly
    # fixture's INT stream exactly, its AUX up to the flush bits
    idx = trc.reference_index_to_flat(str(p))
    q = str(tmp_path / "reenc.bin")
    trc.write_reference_index(q, idx)
    assert _decoded(trc.read_reference_index(q)[0]) == want
    if kind == "doubly":
        got_main, got_aux = _files(q)
        assert got_main == INT_D
        assert got_aux[:3] == AUX_D[:3] and got_aux[3:11] == b"\xff" * 8


@pytest.mark.parametrize("kind", KINDS)
def test_raw_decode_matches(pair_art, tmp_path, kind):
    p = _write(tmp_path, "jax", _index(pair_art[0], kind), "x.bin")
    (got, gh, gd), (want, wh, wd) = trc.read_reference_index(p), jrc.read_reference_index(p)
    assert (gh, gd) == (wh, wd)
    assert len(got["codes"]) == len(want["codes"])
    for a, b in zip(got["codes"], want["codes"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for f in ("rid1", "rid2", "uc1", "uc2"):
        np.testing.assert_array_equal(got[f], want[f])
        assert got[f].dtype == want[f].dtype


@pytest.mark.parametrize("Lmax", [None, 30])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_index_to_flat_matches(pair_art, tmp_path, kind, Lmax):
    p = _write(tmp_path, "jax", _index(pair_art[0], kind), "x.bin")
    got, want = trc.reference_index_to_flat(p, Lmax), jrc.reference_index_to_flat(p, Lmax)
    assert isinstance(got, FlatIndex)
    for f in FLAT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for f in FLAT_STATICS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("sc_mode", [False, True])
@pytest.mark.parametrize("engine", ["sortjoin", "gather"])
def test_session_on_imported_pair_matches_jax(pair_art, tmp_path, engine, sc_mode):
    """A port session on the port's imported pair against a JAX session on
    the JAX package's imported pair (the same files); and against a port
    session on the original pair, rcounts compared by entry key (the
    import orders entries by their trie walk)."""
    art, gs, planted = pair_art
    reads = pair_reads(gs, planted, 7)
    G = 6
    imported = {}
    for who in ("port", "jax"):
        imported[who] = tuple(
            PKG[who].reference_index_to_flat(
                _write(tmp_path, "port", _index(art, k), f"{who}.{k}.bin"), Lmax=30)
            for k in KINDS)
    cfg = dict(h=12, batch_size=128)
    got = QuerySession(*imported["port"], G, QueryConfig(**cfg), device="cpu",
                       engine=engine).run(reads, sc_mode=sc_mode)
    want = JaxSession(*imported["jax"], G, JQueryConfig(**cfg),
                      engine=engine).run(reads, sc_mode=sc_mode)
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.nundet, got.nconf, got.pair_counts) == (want.nundet, want.nconf,
                                                       want.pair_counts)
    assert got.cnts_u.sum() + got.cnts_d.sum() > 0
    if sc_mode:
        assert got.pair_counts
    orig = QuerySession(art.unique_index, art.doubly_index, G, QueryConfig(**cfg),
                        device="cpu", engine=engine).run(reads, sc_mode=sc_mode)
    for f in ("cnts_u", "cnts_d"):
        np.testing.assert_array_equal(getattr(got, f), getattr(orig, f), err_msg=f)
    assert (got.nundet, got.nconf, got.pair_counts) == (orig.nundet, orig.nconf,
                                                       orig.pair_counts)
    for f, ix, ox in (("rcount_u", imported["port"][0], art.unique_index),
                      ("rcount_d", imported["port"][1], art.doubly_index)):
        assert by_entry_key(ix, getattr(got, f)) == by_entry_key(ox, getattr(orig, f)), f
