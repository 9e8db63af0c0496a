"""The port's merged-index artifact command, ``ensure_cuckoo`` and
``MergedArtifact.to_merged_index`` against ``cammiq_tpu/index/artifact.py``:
identical files from ``python -m ... index.artifact`` of both packages,
identical upgraded ``cuckoo.npy`` and ``meta.json``, field-for-field equal
merged indexes, and a session from an upgraded artifact that builds no
cuckoo table and counts as a session from the npz pair does."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cammiq_tpu.index.artifact as jart
from cammiq_tpu.config import BuildConfig
from cammiq_tpu.index.builder import build_index, save_index
from cammiq_tpu.io.fasta import corpus_from_sequences
import cammiq_tpu_torch.index.artifact as tart
import cammiq_tpu_torch.query.merged as tmerged
import cammiq_tpu_torch.query.sortjoin as tsj
from cammiq_tpu_torch.config import QueryConfig
from cammiq_tpu_torch.query.pipeline import QuerySession
from torch_fixture import ALPHA, pair_genomes, pair_reads

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = {"port": tart, "jax": jart}
G = 6
MERGED_FIELDS = ("key_words", "length", "rid1", "rid2", "gid", "color",
                 "pref_lo", "pref_hi", "bucket_start", "bucket_count",
                 "dir_start")
MERGED_STATICS = ("h", "kw", "eu", "ed", "max_bucket", "n_colors", "dir_bits",
                  "dir_span_steps")
COUNT_FIELDS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d")


@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    """An npz pair and its three meta files (5 genomes x 600 bases, a
    segment planted in each pair of neighbours), and the genomes."""
    gs, planted = pair_genomes(33, ng=5, glen=600, seg=120)
    art = build_index(corpus_from_sequences([[ALPHA[x].tobytes()] for x in gs]),
                      BuildConfig(k=12, L=60, Lmax=30, h=12, mode="both"),
                      engine="numpy")
    d = tmp_path_factory.mktemp("npz")
    save_index(art, str(d))
    return d, gs, planted


@pytest.fixture(scope="module")
def merged_dir(npz_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("merged") / "merged"
    tart.prepare_merged(str(npz_dir[0] / "index_u.npz"),
                        str(npz_dir[0] / "index_d.npz"), str(d))
    return d


def _dir_files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def _run_command(pkg, args):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", f"{pkg}.index.artifact", *args],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stderr


@pytest.mark.parametrize("tables", ["both", "unique"])
def test_artifact_command_matches_jax(npz_dir, tmp_path, tables):
    """``python -m cammiq_tpu_torch.index.artifact`` writes the files of
    ``python -m cammiq_tpu.index.artifact``, the meta files included."""
    ins = [str(npz_dir[0] / "index_u.npz")]
    if tables == "both":
        ins.append(str(npz_dir[0] / "index_d.npz"))
    out = {}
    for pkg in ("cammiq_tpu_torch", "cammiq_tpu"):
        out[pkg] = tmp_path / pkg
        err = _run_command(pkg, ["-i", *ins, "-o", str(out[pkg])])
        assert re.search(r"^prepare_merged: load .* -> " + re.escape(str(out[pkg])),
                         err, re.M), err
    got, want = _dir_files(out["cammiq_tpu_torch"]), _dir_files(out["cammiq_tpu"])
    assert sorted(got) == sorted(want)
    assert {"genome_lengths.out", "unique_lmer_count_u.out", "unique_lmer_count_d.out",
            "cuckoo.npy", "meta.json"} <= set(got)
    for name in want:
        assert got[name] == want[name], name
    assert (json.loads(got["meta.json"])["ed"] == 0) == (tables == "unique")


def _pre_cuckoo_copy(src, dst, missing):
    """A copy of the artifact ``src`` as one saved before the cuckoo table:
    ``missing`` is what it lacks (the file, the meta key, or both)."""
    shutil.copytree(src, dst)
    if missing in ("file", "both"):
        os.remove(dst / "cuckoo.npy")
    if missing in ("log", "both"):
        meta = json.loads((dst / "meta.json").read_text())
        meta["cuckoo_log"] = 0
        with open(dst / "meta.json", "w") as f:
            json.dump(meta, f, indent=1)
    return dst


@pytest.mark.parametrize("missing", ["both", "file", "log"])
def test_ensure_cuckoo_matches_jax(merged_dir, tmp_path, capsys, missing):
    """Both packages upgrade a pre-cuckoo copy to the same bytes (those of
    the artifact saved with its table), return True, then False."""
    copies = {who: _pre_cuckoo_copy(merged_dir, tmp_path / who, missing)
              for who in PKG}
    for who, d in copies.items():
        capsys.readouterr()
        assert PKG[who].ensure_cuckoo(str(d), verbose=True) is True
        err = capsys.readouterr().err
        assert re.fullmatch(r"ensure_cuckoo: " + re.escape(str(d))
                            + r": 2\^\d+ rows in \d+\.\ds\n", err), err
        assert PKG[who].ensure_cuckoo(str(d)) is False
    want = _dir_files(merged_dir)
    for who, d in copies.items():
        got = _dir_files(d)
        assert got == want, who
    assert tart.load_merged_artifact(str(copies["port"])).cuckoo is not None


@pytest.mark.parametrize("sc_mode", [False, True])
def test_session_from_upgraded_artifact_builds_no_cuckoo(npz_dir, merged_dir,
                                                         tmp_path, monkeypatch,
                                                         sc_mode):
    """A session from the pre-cuckoo copy (its table built in memory) and,
    once ensure_cuckoo has run, one from the upgraded copy with
    ``_build_cuckoo`` raising: both count as the session from the npz pair."""
    from cammiq_tpu_torch.index.table import load_flat_index_pair

    d, gs, planted = npz_dir
    reads = pair_reads(gs, planted, 11)
    cfg = QueryConfig(h=12, batch_size=128)
    live = QuerySession(*load_flat_index_pair(str(d / "index_u.npz"),
                                              str(d / "index_d.npz")),
                        G, cfg, device="cpu").run(reads, sc_mode=sc_mode)
    pre = _pre_cuckoo_copy(merged_dir, tmp_path / "pre", "both")
    art = tart.load_merged_artifact(str(pre))
    assert art.cuckoo is None
    rebuilt = QuerySession.from_artifact(art, G, cfg, device="cpu").run(
        reads, sc_mode=sc_mode)
    assert tart.ensure_cuckoo(str(pre)) is True

    def no_build(*a, **k):
        raise AssertionError("_build_cuckoo called")

    monkeypatch.setattr(tsj, "_build_cuckoo", no_build)
    monkeypatch.setattr(tmerged, "_build_cuckoo", no_build)
    upgraded = QuerySession.from_artifact(tart.load_merged_artifact(str(pre)), G,
                                          cfg, device="cpu").run(reads, sc_mode=sc_mode)
    for got in (rebuilt, upgraded):
        for f in COUNT_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(live, f), err_msg=f)
        assert (got.nundet, got.nconf, got.pair_counts) == (
            live.nundet, live.nconf, live.pair_counts)
    assert live.cnts_u.sum() + live.cnts_d.sum() > 0
    if sc_mode:
        assert live.pair_counts


def test_to_merged_index_matches_jax(npz_dir, merged_dir):
    """Field for field against the JAX package's, and against the merged
    index built from the npz pair."""
    from cammiq_tpu_torch.index.table import load_flat_index_pair

    got = tart.load_merged_artifact(str(merged_dir)).to_merged_index()
    want = jart.load_merged_artifact(str(merged_dir)).to_merged_index()
    built = tmerged.build_merged_index(*load_flat_index_pair(
        str(npz_dir[0] / "index_u.npz"), str(npz_dir[0] / "index_d.npz")))
    assert isinstance(got, tmerged.MergedIndex)
    for f in MERGED_FIELDS:
        for other in (want, built):
            np.testing.assert_array_equal(getattr(got, f), getattr(other, f), err_msg=f)
        assert np.asarray(getattr(got, f)).dtype == np.asarray(getattr(want, f)).dtype, f
    for f in MERGED_STATICS:
        assert getattr(got, f) == getattr(want, f) == getattr(built, f), f
