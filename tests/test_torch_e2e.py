"""End to end through both CLIs on the test_e2e.py toy DB: the port
(`python -m cammiq_tpu_torch.cli --device cpu`) against `cammiq_tpu.cli`,
the index build included."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cammiq_tpu.cli import main as jax_cli_main
from cammiq_tpu.models.output import parse_quant_output
from cammiq_tpu.tools.simulate import simulate
from cammiq_tpu_torch.cli import main as cli_main
from torch_fixture import ALPHA, pair_genomes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_FLAGS = ["--both", "-k", "20", "-L", "100", "-Lmax", "40", "-h", "20"]

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_toydb")
    rng = np.random.default_rng(42)
    db = root / "fasta"
    db.mkdir()
    with open(root / "genome_map.out", "w") as m:
        for g in range(5):
            s = ALPHA[rng.integers(0, 4, size=2000)].tobytes().decode()
            with open(db / f"genome{g + 1}.fasta", "w") as f:
                f.write(f">g{g + 1} contig1\n")
                f.writelines(s[i:i + 80] + "\n" for i in range(0, len(s), 80))
            m.write(f"genome{g + 1}.fasta\t{g + 1}\t{1000 + g}\tGenome_{g + 1}\n")
    mapf = str(root / "genome_map.out")
    iu, idd = str(root / "index_u.npz"), str(root / "index_d.npz")
    cli_main(["--device", "cpu", "--build", "--both", "-f", mapf, "-D",
              str(db) + "/", "-k", "20", "-L", "100", "-Lmax", "40", "-h",
              "20", "-i", iu, idd, "--engine", "numpy"])
    fq = str(root / "reads.fq")
    simulate(mapf, str(db), fq, str(root / "truth.out"), num_reads=3000,
             L=100, erate=0.01, dist="lognormal", seed=7)
    return root, ["-f", mapf, "-i", iu, idd, "-q", fq, "-e", "0.01"]


def test_type1_output_byte_identical(toy):
    root, args = toy
    ours, ref = root / "t1_torch.out", root / "t1_jax.out"
    cli_main(["--device", "cpu", "--query", "--read_cnts", *args, "-o", str(ours)])
    jax_cli_main(["--query", "--read_cnts", *args, "-o", str(ref)])
    assert ours.read_bytes() == ref.read_bytes()
    assert ours.read_text().startswith("QUERY/TAXID\t1000\t1001")


def test_quant_matches_jax_cli(toy):
    root, args = toy
    ours, ref = root / "q_torch.out", root / "q_jax.out"
    cli_main(["--device", "cpu", "--query", *args, "-o", str(ours)])
    jax_cli_main(["--query", *args, "-o", str(ref)])
    got = {t: a for t, a, _ in parse_quant_output(str(ours))[0]["rows"]}
    want = {t: a for t, a, _ in parse_quant_output(str(ref))[0]["rows"]}
    assert sorted(got) == sorted(want) == [1000, 1001, 1002, 1003, 1004]
    assert sum(abs(got[t] - want[t]) for t in want) <= 1e-3


def test_cli_never_imports_jax(toy):
    root, args = toy
    out = root / "q_sub.out"
    code = ("import sys; from cammiq_tpu_torch.cli import main; "
            f"main({['--device', 'cpu', '--query', *args, '-o', str(out)]!r}); "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(parse_quant_output(str(out))[0]["rows"]) == 5


def test_cuda_without_card_raises(toy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, args = toy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--device", "cuda", "--query", *args,
                  "-o", str(root / "never.out")])
    assert not (root / "never.out").exists()


def test_unported_modes_raise(toy):
    root, args = toy
    with pytest.raises(NotImplementedError):
        cli_main(["--device", "cpu", "--query", "-t", "2", *args,
                  "-o", str(root / "t.out")])


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}


@pytest.mark.parametrize("engine", [None, "numpy"])
def test_build_cli_any_engine_matches_jax_cli(toy, engine):
    """``--build`` runs the port's build on ``--device`` whatever
    ``--engine`` says, in a child process that loads nothing of the JAX
    package, and writes the tables (every array, byte for byte) and the
    meta files of ``cammiq_tpu.cli --build``."""
    root, args = toy
    mapf, db = args[1], str(root / "fasta") + "/"
    ours, ref = root / f"cli_{engine}", root / f"cli_ref_{engine}"
    flags = [*BUILD_FLAGS, "-f", mapf, "-D", db]
    argv = ["--device", "cpu", "--build", *flags, "-i", str(ours / "index_u.npz"),
            str(ours / "index_d.npz")] + (["--engine", engine] if engine else [])
    code = ("import sys; from cammiq_tpu_torch.cli import main; "
            f"main({argv!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cammiq_tpu', 'jax')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Time for computing suffix array" in r.stderr
    jax_cli_main(["--build", *flags, "-i", str(ref / "index_u.npz"),
                  str(ref / "index_d.npz"), "--engine", "numpy"])
    for name in ("index_u.npz", "index_d.npz"):
        got, want = _npz_arrays(ours / name), _npz_arrays(ref / name)
        assert got == want, name
    for name in ("genome_lengths.out", "unique_lmer_count_u.out",
                 "unique_lmer_count_d.out"):
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


def test_build_hosts_raises(toy, tmp_path):
    root, args = toy
    with pytest.raises(NotImplementedError, match="build_hosts"):
        cli_main(["--device", "cpu", "--build", *BUILD_FLAGS, "-f", args[1],
                  "-D", str(root / "fasta") + "/", "--build_hosts", "2",
                  "-i", str(tmp_path / "u.npz"), str(tmp_path / "d.npz")])
    assert not any(tmp_path.iterdir())


@pytest.fixture(scope="module")
def pair_toy(tmp_path_factory):
    """5 genomes x 2000 bp with a 300 bp segment planted in each pair of
    neighbours, indexed by cammiq_tpu.cli (numpy engine), and 3000
    simulated reads."""
    root = tmp_path_factory.mktemp("torch_pairdb")
    gs, _ = pair_genomes(5, glen=2000, seg=300)
    db = root / "fasta"
    db.mkdir()
    with open(root / "genome_map.out", "w") as m:
        for g, x in enumerate(gs):
            s = ALPHA[x].tobytes().decode()
            with open(db / f"genome{g + 1}.fasta", "w") as f:
                f.write(f">g{g + 1} contig1\n")
                f.writelines(s[i:i + 80] + "\n" for i in range(0, len(s), 80))
            m.write(f"genome{g + 1}.fasta\t{g + 1}\t{1000 + g}\tGenome_{g + 1}\n")
    mapf = str(root / "genome_map.out")
    idx = root / "idx"
    jax_cli_main(["--build", *BUILD_FLAGS, "-f", mapf, "-D", str(db) + "/",
                  "-i", str(idx / "index_u.npz"), str(idx / "index_d.npz"),
                  "--engine", "numpy"])
    fq = str(root / "reads.fq")
    simulate(mapf, str(db), fq, str(root / "truth.out"), num_reads=3000,
             L=100, erate=0.01, dist="uniform", seed=3)
    return root, mapf, str(db) + "/", idx, fq


def test_type2_output_byte_identical(pair_toy):
    from cammiq_tpu.config import QueryConfig
    from cammiq_tpu.index.table import load_flat_index_pair
    from cammiq_tpu.io.fastq import read_fastq
    from cammiq_tpu.query.pipeline import QuerySession as JaxSession

    root, mapf, _, idx, fq = pair_toy
    iu, idd = str(idx / "index_u.npz"), str(idx / "index_d.npz")
    index_u, index_d = load_flat_index_pair(iu, idd)
    want = JaxSession(index_u, index_d, 6, QueryConfig(h=20),
                      engine="sortjoin").run(read_fastq(fq), sc_mode=True)
    assert want.pair_counts and max(want.pair_counts.values()) > 0
    args = ["--query", "--read_cnts", "--doubly_unique", "-f", mapf, "-i", iu,
            idd, "-q", fq, "-e", "0.01"]
    ours, ref = root / "t2_torch.out", root / "t2_jax.out"
    cli_main(["--device", "cpu", *args, "-o", str(ours)])
    jax_cli_main([*args, "-o", str(ref)])
    assert ours.read_bytes() == ref.read_bytes()
    assert ours.read_text().startswith("QUERY/TAXID\t1000\t1001")


def test_device_build_cli_never_imports_jax(pair_toy):
    """``--build --engine jax`` runs the port's device build, here on the
    CPU, without importing jax, and writes the tables and meta files of
    the host build."""
    from cammiq_tpu.index.table import load_flat_index

    root, mapf, db, idx, _ = pair_toy
    out = root / "idx_torch"
    argv = ["--device", "cpu", "--build", *BUILD_FLAGS, "--engine", "jax",
            "-f", mapf, "-D", db, "-i", str(out / "index_u.npz"),
            str(out / "index_d.npz")]
    code = ("import sys; from cammiq_tpu_torch.cli import main; "
            f"main({argv!r}); "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Time for computing OCC array (doubly)" in r.stderr
    for name in ("index_u.npz", "index_d.npz"):
        got, want = load_flat_index(str(out / name)), load_flat_index(str(idx / name))
        for f in ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2",
                  "table_lo", "table_hi", "table_start", "table_count"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{name}.{f}")
        assert got.num_entries > 0
    for name in ("genome_lengths.out", "unique_lmer_count_u.out",
                 "unique_lmer_count_d.out"):
        assert (out / name).read_bytes() == (idx / name).read_bytes(), name


def test_device_build_cli_without_card_raises(pair_toy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, mapf, db, _, _ = pair_toy
    out = root / "never"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--device", "cuda", "--build", *BUILD_FLAGS, "--engine", "jax",
                  "-f", mapf, "-D", db, "-i", str(out / "index_u.npz"),
                  str(out / "index_d.npz")])
    assert not out.exists()
