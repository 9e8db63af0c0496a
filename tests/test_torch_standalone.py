"""The port stands alone: it imports nothing of the JAX package, and its
copies of the JAX package's host modules give the same output on the same
numpy-seeded inputs (bit-identical arrays, identical files)."""

import ast
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import cammiq_tpu.cli as jcli
import cammiq_tpu.config as jcfg
import cammiq_tpu.index.artifact as jart
import cammiq_tpu.index.sparsify as jsp
import cammiq_tpu.index.table as jtab
import cammiq_tpu.io.fasta as jfasta
import cammiq_tpu.io.fastq as jfastq
import cammiq_tpu.io.mapfile as jmap
import cammiq_tpu.models.ident as jident
import cammiq_tpu.models.output as jout
import cammiq_tpu.models.quant as jquant
import cammiq_tpu.query.pipeline as jpipe
import cammiq_tpu.query.sortjoin as jsj
import cammiq_tpu.tools.simulate as jsim
import cammiq_tpu_torch.cli as tcli
import cammiq_tpu_torch.config as tcfg
import cammiq_tpu_torch.index.artifact as tart
import cammiq_tpu_torch.index.sparsify as tsp
import cammiq_tpu_torch.index.table as ttab
import cammiq_tpu_torch.io.fasta as tfasta
import cammiq_tpu_torch.io.fastq as tfastq
import cammiq_tpu_torch.io.mapfile as tmap
import cammiq_tpu_torch.models.ident as tident
import cammiq_tpu_torch.models.output as tout
import cammiq_tpu_torch.models.quant as tquant
import cammiq_tpu_torch.query.merged as tmerged
import cammiq_tpu_torch.query.pipeline as tpipe
import cammiq_tpu_torch.tools.simulate as tsim
from benchmarks.build_scale import gen_genomes as jax_gen_genomes
from cammiq_tpu_torch import native
from cammiq_tpu_torch.index import unique as uq
from cammiq_tpu_torch.kernels.lcp_pairs import lcp_pairs
from cammiq_tpu_torch.ops.sa import suffix_array
from cammiq_tpu_torch.tools import benchdata
from torch_fixture import ALPHA, pair_genomes

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p.relative_to(REPO).as_posix()
                    for p in (REPO / "cammiq_tpu_torch").rglob("*.py"))
FORBIDDEN = ("cammiq_tpu", "bench", "benchmarks", "jax", "jaxlib")

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_jax_package_import(path):
    """Every import in the port's modules and in chip_smoke.py, at any depth
    (inside functions too), names neither the JAX package, the bench
    scripts, nor jax."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [(m, ln) for m, ln in _imported_roots(tree) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_without_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cammiq_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'cammiq_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('cammiq_tpu', 'jax', 'bench', 'benchmarks'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('cammiq_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout) >= 30


# ---- config and command line

@pytest.mark.parametrize("name,kwargs", [
    ("BuildConfig", {}),
    ("BuildConfig", dict(k=20, L=100, Lmax=40, h=20, h2=18, mode="unique",
                         num_groups=3, bounded_sa=False)),
    ("FineParams", dict(read_cnt_thres=7, ilp_alpha=0.5)),
    ("IdentFineParams", dict(unique_read_cnt_thres=3)),
    ("QueryConfig", dict(h=20, erate=0.01, id_mode=2, batch_size=8192)),
])
def test_config_matches(name, kwargs):
    got, want = getattr(tcfg, name)(**kwargs), getattr(jcfg, name)(**kwargs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("sa_depth", "h_doubly"):
        if hasattr(want, prop):
            assert getattr(got, prop) == getattr(want, prop)
    for const in ("MAX_K", "MAX_L", "MIN_H", "MAX_H", "MAX_N", "MAX_M", "MAX_C"):
        assert getattr(tcfg, const) == getattr(jcfg, const)


@pytest.mark.parametrize("kwargs", [dict(k=4), dict(L=0), dict(Lmax=20),
                                    dict(h=40), dict(h=30), dict(mode="x"),
                                    dict(num_groups=0)])
def test_build_config_rejects_like_jax(kwargs):
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError):
            mod.BuildConfig(**kwargs)


@pytest.mark.parametrize("argv", [
    ["--build", "--both", "-f", "m.out", "-D", "db/", "-k", "20", "-L", "100",
     "-Lmax", "40", "-h", "20", "-i", "u.npz", "d.npz"],
    ["--build", "--unique", "-f", "m.out", "-h", "20", "18", "-t", "3",
     "--exact_sa", "--merged", "mdir", "--engine", "numpy"],
    ["--build", "--doubly_unique", "--build_hosts", "2", "-i", "u.npz"],
    ["--query", "-f", "m.out", "-i", "u.npz", "d.npz", "-q", "a.fq", "b.fq",
     "-o", "q.out", "-e", "0.01", "--read_length_filter", "50"],
    ["--query", "--read_cnts", "--doubly_unique", "-Q", "fq/", "-i", "m",
     "--unique_read_cnt_thres", "3", "--doubly_unique_read_cnt_thres", "2"],
    ["--query", "--read_cnt_thres", "5", "--easy_to_identify_thres", "9",
     "--ilp_epsilon", "0.1", "--ilp_alpha", "0.2", "--max_depth", "7",
     "--ilp_time_limit", "60", "--ilp_enum_cap", "4", "--model_shards", "2",
     "--profile", "p", "--enable_ilp_display", "-t", "2"],
])
def test_parse_args_matches(argv):
    assert tcli.parse_args(list(argv)) == jcli.parse_args(list(argv))


def test_parse_args_rejects_unknown_flag(capsys):
    for mod in (tcli, jcli):
        with pytest.raises(SystemExit) as e:
            mod.parse_args(["--query", "--nope"])
        assert e.value.code == 1
    assert capsys.readouterr().err.count("Failed to recognize option: --nope.") == 2


# ---- corpus, reads, map files

@pytest.fixture(scope="module")
def fasta_db(tmp_path_factory):
    """Three genomes in FASTA files (one with two contigs and a lower-case
    run), a map file, and the same genomes as in-memory contigs."""
    root = tmp_path_factory.mktemp("standalone_db")
    rng = np.random.default_rng(11)
    genomes, files = [], []
    with open(root / "map.out", "w") as m:
        for g in range(3):
            contigs = [ALPHA[rng.integers(0, 4, 700 + 50 * g)].tobytes()]
            if g == 1:
                contigs.append(ALPHA[rng.integers(0, 4, 300)].tobytes().lower())
            genomes.append(contigs)
            fn = f"genome{g + 1}.fasta"
            with open(root / fn, "wb") as f:
                for c, s in enumerate(contigs):
                    f.write(f">g{g + 1}c{c}\n".encode())
                    f.writelines(s[i:i + 60] + b"\n" for i in range(0, len(s), 60))
            m.write(f"{fn}\t{g + 1}\t{500 + g}\tName_{g + 1}\n")
            files.append((str(root / fn), g + 1))
    return root, files, genomes


CORPUS_FIELDS = ("seq", "contig_pos", "ref_pos", "ref_id")


def test_corpus_matches(fasta_db):
    root, files, genomes = fasta_db
    pairs = [(tfasta.build_corpus(files), jfasta.build_corpus(files)),
             (tfasta.corpus_from_sequences(genomes),
              jfasta.corpus_from_sequences(genomes))]
    assert (tfasta.read_map_file(str(root / "map.out"), str(root))
            == jfasta.read_map_file(str(root / "map.out"), str(root)))
    assert tfasta.list_fasta_dir(str(root)) == jfasta.list_fasta_dir(str(root))
    for got, want in pairs:
        for f in CORPUS_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
        assert got.filenames == want.filenames
        np.testing.assert_array_equal(got.genome_lengths(), want.genome_lengths())


def test_map_file_and_genome_lengths_match(fasta_db, tmp_path):
    root, _, _ = fasta_db
    for fn, rows in (("genome_lengths.out", "1\t700\n2\t1050\n3\t800\n1\t701\n"),
                     ("unique_lmer_count_u.out", "1\t5\n3\t9\n"),
                     ("unique_lmer_count_d.out", "2\t4\n")):
        (tmp_path / fn).write_text(rows)
    got, want = tmap.load_smap(str(root / "map.out")), jmap.load_smap(str(root / "map.out"))
    tmap.load_genome_lengths(got, str(tmp_path))
    jmap.load_genome_lengths(want, str(tmp_path))
    for a, b in zip(got.arrays(), want.arrays()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.taxids(), want.taxids())
    assert [g.name for g in got.genomes[1:]] == [g.name for g in want.genomes[1:]]


def _write_fastq(path, rng, n_rate):
    with open(path, "w") as f:
        for r in range(300):
            s = ALPHA[rng.integers(0, 4, int(rng.integers(30, 140)))].tobytes().decode()
            if n_rate:
                s = "".join("N" if rng.random() < n_rate else c for c in s)
            f.write(f"@r{r}\n{s}\n+\n{'I' * len(s)}\n")


@pytest.mark.parametrize("engine", ["python", "native"])
def test_read_fastq_matches(tmp_path, engine):
    """The python engine against the JAX package's on reads with N's (both
    draw substitutions from default_rng(0)); the port's native parser
    (where a compiler builds it) against the JAX python engine on reads
    without N's, where no substitution is drawn."""
    path = str(tmp_path / "r.fq")
    _write_fastq(path, np.random.default_rng(3), 0.02 if engine == "python" else 0)
    if engine == "native" and not native.available():
        pytest.skip(f"native library not built: {native.build_error()}")
    got = tfastq.read_fastq(path, min_len=40, max_len=128, engine=engine)
    want = jfastq.read_fastq(path, min_len=40, max_len=128, engine="python")
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert (got.total_len, got.name) == (want.total_len, want.name)
    bt = list(got.batches(128))
    bj = list(want.batches(128))
    assert len(bt) == len(bj) and all(
        np.array_equal(a.codes, b.codes) and a.count == b.count for a, b in zip(bt, bj))


def test_reads_from_arrays_matches():
    rng = np.random.default_rng(4)
    seqs = [ALPHA[rng.integers(0, 4, int(rng.integers(20, 90)))].tobytes()
            for _ in range(40)]
    got, want = tfastq.reads_from_arrays(seqs, 96), jfastq.reads_from_arrays(seqs, 96)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.lengths, want.lengths)


# ---- index build: selection, flat tables, merged index, artifact

@pytest.fixture(scope="module")
def stages():
    """Selection inputs from the port's device stages on the CPU (held to
    their JAX twins in test_torch_build.py), for the unique and doubly
    variants, and the corpus in both packages' types."""
    gs, _ = pair_genomes(9, ng=5, glen=600, seg=120)
    contigs = [[ALPHA[x].tobytes()] for x in gs]
    tc, jc = tfasta.corpus_from_sequences(contigs), jfasta.corpus_from_sequences(contigs)
    n = tc.n
    text = torch.from_numpy(tc.seq.copy())
    sa = suffix_array(text)
    lcp = lcp_pairs(text, sa)
    gsa = uq.compute_gsa(sa, tc.ref_pos, tc.ref_id)
    lcp0 = uq.unique_lcp0(gsa, lcp, 11)
    occ = uq.occ_unique(sa, gsa, lcp, lcp0).to(torch.uint8).numpy()
    mu = uq.min_unique(sa, lcp0, n).numpy()
    dl, g2 = uq.doubly_lcp0(sa, gsa, lcp, 11, 60)
    occ_d, occ2_d = (o.to(torch.uint8).numpy() for o in uq.occ_doubly(sa, gsa, g2, lcp, dl, 60))
    mu_d = uq.min_unique(sa, dl, n, ulmax=60).numpy()
    return {"t": tc, "j": jc, "unique": dict(mu=mu, occ=occ),
            "doubly": dict(mu=mu_d, occ=occ_d, gsa2_text=g2.numpy(), occ2=occ2_d)}


SEL_FIELDS = ("start", "length", "rid", "occ", "rid2", "occ2", "ulm_count")


def _select(mod, corpus, kind, engine, st):
    a = st[kind]
    kw = {} if kind == "unique" else dict(gsa2_text=a["gsa2_text"], occ2=a["occ2"])
    return mod.select_substrings(corpus, a["mu"], a["occ"], 60, 30,
                                 engine=engine, **kw)


@pytest.mark.parametrize("kind", ["unique", "doubly"])
@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_select_substrings_matches(stages, kind, engine):
    got = _select(tsp, stages["t"], kind, engine, stages)
    want = _select(jsp, stages["j"], kind, engine, stages)
    assert got.size > 0
    for f in SEL_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert tsp.MU_EMPTY == 0xFFFF


FLAT_FIELDS = ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2",
               "table_lo", "table_hi", "table_start", "table_count")
FLAT_STATICS = ("h", "kw", "max_probes", "max_bucket", "is_doubly")


def _assert_flat_equal(got, want):
    for f in FLAT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    for f in FLAT_STATICS:
        assert getattr(got, f) == getattr(want, f), f


@pytest.fixture(scope="module")
def flat_pair(stages):
    """(port, JAX) FlatIndex of the unique and of the doubly selection."""
    out = {}
    for kind, h, doubly in (("unique", 12, False), ("doubly", 12, True)):
        out[kind] = tuple(
            mod.build_flat_index(stages[c].seq, _select(sp, stages[c], kind, "fast", stages),
                                 h, 30, doubly)
            for mod, sp, c in ((ttab, tsp, "t"), (jtab, jsp, "j")))
    return out


@pytest.mark.parametrize("kind", ["unique", "doubly"])
def test_flat_index_matches(flat_pair, kind):
    got, want = flat_pair[kind]
    assert got.num_entries > 0
    _assert_flat_equal(got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flat_index_file_read_by_both(flat_pair, tmp_path, writer):
    got, want = flat_pair["doubly"]
    path = str(tmp_path / "idx.npz")
    (ttab if writer == "port" else jtab).save_flat_index(path, got)
    _assert_flat_equal(ttab.load_flat_index(path), want)
    _assert_flat_equal(jtab.load_flat_index(path), want)


MERGED_FIELDS = ("key_words", "length", "rid1", "rid2", "gid", "color",
                 "pref_lo", "pref_hi", "bucket_start", "bucket_count",
                 "dir_start")
MERGED_STATICS = ("h", "kw", "eu", "ed", "max_bucket", "n_colors", "dir_bits",
                  "dir_span_steps")


def test_merged_index_and_device_tables_match(flat_pair):
    (tu, ju), (td, jd) = flat_pair["unique"], flat_pair["doubly"]
    got, want = tmerged.build_merged_index(tu, td), jsj.build_merged_index(ju, jd)
    for f in MERGED_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in MERGED_STATICS:
        assert getattr(got, f) == getattr(want, f), f
    for a, b in zip(tmerged._build_bloom(got.pref_lo), jsj._build_bloom(want.pref_lo)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmerged._build_cuckoo(got.pref_lo, got.bucket_start, got.bucket_count),
                    jsj._build_cuckoo(want.pref_lo, want.bucket_start, want.bucket_count)):
        np.testing.assert_array_equal(a, b)
    table, _ = tmerged._build_bloom(got.pref_lo, 16)
    for a, b in zip(tmerged._fold_bloom(table, 12), jsj._fold_bloom(table, 12)):
        np.testing.assert_array_equal(a, b)
    args = [getattr(got, f) for f in ("key_words", "length", "color", "bucket_start",
                                      "bucket_count", "gid", "rid1", "rid2")]
    for a, b in zip(tmerged._fused_records(*args), jsj._fused_records(*args, np)):
        np.testing.assert_array_equal(a, b)
    assert tmerged.BLOOM_DEVICE_LOG == jsj.BLOOM_DEVICE_LOG


ART_FIELDS = ("erec", "prec", "pref_lo", "pref_hi", "brec", "bloom", "cuckoo")
ART_STATICS = ("h", "kw", "eu", "ed", "max_bucket", "n_colors", "E", "NB",
               "bloom_log", "cuckoo_log")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_merged_artifact_read_by_both(flat_pair, tmp_path, writer):
    """One package writes the artifact (prepare_merged from the .npz pair),
    both read it; the port's session takes either package's handle."""
    (tu, ju), (td, jd) = flat_pair["unique"], flat_pair["doubly"]
    ttab.save_flat_index(str(tmp_path / "u.npz"), tu)
    ttab.save_flat_index(str(tmp_path / "d.npz"), td)
    out = str(tmp_path / "merged")
    (tart if writer == "port" else jart).prepare_merged(
        str(tmp_path / "u.npz"), str(tmp_path / "d.npz"), out)
    assert tart.is_merged_artifact(out) and jart.is_merged_artifact(out)
    got, want = tart.load_merged_artifact(out), jart.load_merged_artifact(out)
    for f in ART_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ART_STATICS:
        assert getattr(got, f) == getattr(want, f), f
    for pg, pw in zip(got.payloads(), want.payloads()):
        for f in ("length", "rid1", "rid2", "ucount1", "ucount2"):
            np.testing.assert_array_equal(getattr(pg, f), getattr(pw, f))
    from cammiq_tpu_torch.query.sortjoin import TorchMergedIndex

    a, b = (TorchMergedIndex.from_artifact(x, "cpu") for x in (got, want))
    for f in ("bloom", "cuckoo", "erec", "prec"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- solvers and output

def test_build_problem_and_host_bound_match(flat_pair):
    (tu, ju), (td, jd) = flat_pair["unique"], flat_pair["doubly"]
    rng = np.random.default_rng(5)
    G = 6
    cu = rng.integers(0, 300, G).astype(np.float64)
    cd = rng.integers(0, 50, G).astype(np.float64)
    nus = rng.integers(5000, 20000, G).astype(np.float64)
    nds = rng.integers(0, 2000, G).astype(np.float64)
    gl = rng.integers(500, 900, G)
    ru = rng.integers(0, 9, tu.num_entries)
    rd = rng.integers(0, 9, td.num_entries)
    fine = tcfg.FineParams(read_cnt_thres=10, easy_to_identify_thres=10000)
    args = (ru, rd, cu, cd, nus, nds, gl, 100, 2000, 0.01)
    got = tquant.build_problem(tu, td, *args, fine)
    want = jquant.build_problem(ju, jd, *args, jcfg.FineParams(**dataclasses.asdict(fine)))
    assert got.exist0.any()
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    np.testing.assert_array_equal(tquant.prefilter(cu, cd, nus, nds, fine),
                                  jquant.prefilter(cu, cd, nus, nds, fine))
    x = rng.random(G) * 5
    lam = rng.random(len(want.c2_species))
    lb, ub = np.zeros(G), np.full(G, 100.0)
    assert (tquant._make_host_bound(got)(x, lam, lb, ub)
            == jquant._make_host_bound(want)(x, lam, lb, ub))


def test_solve_ident_matches():
    rng = np.random.default_rng(8)
    n = 12
    cu = rng.integers(0, 20, n)
    cd = rng.integers(0, 12, n)
    pairs = {}
    for _ in range(25):
        a, b = sorted(rng.choice(np.arange(1, n), 2, replace=False))
        pairs[(int(a), int(b))] = int(rng.integers(1, 15))
    for t1, t2 in ((10, 5), (15, 3)):
        got = tident.solve_ident(cu, cd, pairs, tcfg.IdentFineParams(t1, t2))
        want = jident.solve_ident(cu, cd, pairs, jcfg.IdentFineParams(t1, t2))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_output_writers_match(fasta_db, tmp_path):
    root, _, _ = fasta_db
    rng = np.random.default_rng(6)
    exist = np.array([False, True, False, True])
    cov = rng.random(4)
    counts = rng.integers(0, 99, 4)
    texts = []
    for mod, mapmod in ((tout, tmap), (jout, jmap)):
        table = mapmod.load_smap(str(root / "map.out"))
        quant = tmp_path / f"{mod.__name__}.quant"
        with open(quant, "w") as f:
            mod.write_quant_block(f, "a.fq", table, exist, cov, last_file=False)
            mod.write_quant_block(f, "b.fq", table, exist, cov * 2, last_file=True)
        counts_file = tmp_path / f"{mod.__name__}.counts"
        with open(counts_file, "w") as f:
            mod.write_counts_header(f, table)
            mod.write_counts_row(f, "a.fq", counts, table.n_species)
        texts.append((quant.read_text(), counts_file.read_text(),
                      mod.parse_quant_output(str(quant))))
    assert texts[0] == texts[1]
    assert [b["file"] for b in texts[0][2]] == ["a.fq", "b.fq"]


def test_query_counts_fields_match():
    assert ([(f.name, f.type) for f in dataclasses.fields(tpipe.QueryCounts)]
            == [(f.name, f.type) for f in dataclasses.fields(jpipe.QueryCounts)])


# ---- tools

@pytest.mark.parametrize("dist,erate", [("uniform", 0.0), ("lognormal", 0.02)])
def test_simulate_matches(fasta_db, tmp_path, dist, erate):
    root, _, _ = fasta_db
    outs = []
    for mod in (tsim, jsim):
        fq, rep = tmp_path / f"{mod.__name__}.fq", tmp_path / f"{mod.__name__}.txt"
        truth = mod.simulate(str(root / "map.out"), str(root), str(fq), str(rep),
                             num_reads=200, L=80, erate=erate, nrate=0.01,
                             dist=dist, seed=4)
        outs.append((fq.read_bytes(), rep.read_bytes(), truth))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) > 200 * 80


def test_bench_data_matches():
    got = benchdata.gen_genomes(4, 60_000, seed=2)
    want = jax_gen_genomes(4, 60_000, seed=2)
    assert got == want
    assert (benchdata.BENCH_GENOMES, benchdata.BENCH_GLEN) == (1000, 300_000)
    reads = [fn(np.random.default_rng(9), got, 257)
             for fn in (benchdata.sample_read_batch, bench.sample_read_batch)]
    for a, b in zip(*reads):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ---- the port's native build

def test_native_build_is_atomic(tmp_path, monkeypatch):
    """Four threads build the library into an empty directory at once:
    the lock lets one compile; every one gets the same complete file."""
    import shutil

    if not any(shutil.which(c) for c in (os.environ.get("CXX", "g++"), "/usr/bin/g++")):
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native._build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1 and paths[0] is not None
    assert paths[0].parent == tmp_path / "build"
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [paths[0].name, "native.lock"])
    import ctypes

    assert ctypes.CDLL(str(paths[0])).cammiq_select
    assert not list((REPO / "native").glob("*.tmp"))
