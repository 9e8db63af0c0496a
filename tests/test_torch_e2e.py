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
from cammiq_tpu_torch import native as port_native
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


def test_unported_modes_raise(toy, tmp_path, monkeypatch):
    """The distributed query is ported: ``-t 2`` no longer raises, and with
    no launcher it runs the single-device session (test_torch_dist.py runs
    it over ranks).  The cross-host build is ported too
    (``test_build_hosts_raises``)."""
    root, args = toy
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cli_main(["--device", "cpu", "--query", "--read_cnts", "-t", "2", *args,
              "-o", str(root / "t.out")])
    assert (root / "t.out").read_text().startswith("QUERY/TAXID")


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}


def _run_child(code, tmp_path, jax=False):
    """Run ``code`` in a child process (its own TMPDIR under ``tmp_path``);
    a JAX child is held to the CPU, as tests/conftest.py holds this one."""
    if jax:
        code = "import jax; jax.config.update('jax_platforms', 'cpu'); " + code
    tmp = tmp_path / "tmp"
    tmp.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", TMPDIR=str(tmp),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stderr


def _port_cli_child(argv, tmp_path, host=False):
    """The port's CLI in a child process that must load nothing of the JAX
    package, and on a host build (``host``) not torch either; returns its
    stderr."""
    banned = ("cammiq_tpu", "jax") + (("torch",) if host else ())
    return _run_child(
        "import sys; from cammiq_tpu_torch.cli import main; "
        f"main({argv!r}); "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r}]; assert not bad, bad", tmp_path)


def _assert_same_build_files(ours, ref):
    for name in ("index_u.npz", "index_d.npz"):
        got, want = _npz_arrays(ours / name), _npz_arrays(ref / name)
        assert got == want, name
    for name in ("genome_lengths.out", "unique_lmer_count_u.out",
                 "unique_lmer_count_d.out"):
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


@pytest.mark.parametrize("engine", [None, "numpy", "native", "jax"])
def test_build_cli_any_engine_matches_jax_cli(toy, tmp_path, engine):
    """``--build`` in a child process that loads nothing of the JAX package:
    ``--engine native|numpy`` runs the port's host engine, the default
    (``auto``) and ``jax`` the device build on ``--device``; each writes
    the tables (every array, byte for byte) and the meta files of
    ``cammiq_tpu.cli --build``, with the same host engine, or ``numpy``
    for the device build (a full sort, as the device's).  A host build
    loads no torch."""
    root, args = toy
    mapf, db = args[1], str(root / "fasta") + "/"
    ours, ref = root / f"cli_{engine}", root / f"cli_ref_{engine}"
    flags = [*BUILD_FLAGS, "-f", mapf, "-D", db]
    argv = ["--device", "cpu", "--build", *flags, "-i", str(ours / "index_u.npz"),
            str(ours / "index_d.npz")] + (["--engine", engine] if engine else [])
    err = _port_cli_child(argv, tmp_path, host=engine in ("native", "numpy"))
    assert "Time for computing suffix array" in err
    line = {None: "device (cpu)", "jax": "device (cpu)", "numpy": "numpy, host",
            "native": "native bounded sort, host"}[engine]
    if engine == "native" and not port_native.has_bsort():
        line = "numpy (native library unavailable"
    assert f"build engine: {line}" in err
    jargv = ["--build", *flags, "-i", str(ref / "index_u.npz"), str(ref / "index_d.npz"),
             "--engine", engine if engine in ("native", "numpy") else "numpy"]
    # the JAX native engine in a child of its own: this process may hold a
    # library it found half-built at collection
    _run_child(f"from cammiq_tpu.cli import main; main({jargv!r})", tmp_path, jax=True)
    _assert_same_build_files(ours, ref)


def test_build_hosts_raises(toy, tmp_path):
    """``--build --build_hosts 2`` no longer raises: it runs the cross-host
    build from a streamed corpus, in a child process that loads nothing of
    the JAX package, and writes the tables (array for array) and meta files
    of ``cammiq_tpu.cli --build --build_hosts 2``; it loads no torch and
    leaves no work directory behind."""
    if not port_native.has_bsort():
        pytest.skip("port native bounded sort not built")
    root, args = toy
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    flags = ["--build", *BUILD_FLAGS, "-f", args[1], "-D", str(root / "fasta") + "/",
             "--build_hosts", "2"]
    err = _port_cli_child(["--device", "cpu", *flags, "-i", str(ours / "index_u.npz"),
                           str(ours / "index_d.npz")], tmp_path, host=True)
    assert "build engine: cross-host, 2 slices" in err
    assert "[dist-build] p4_select: peak RSS MB per worker" in err
    assert not any((tmp_path / "tmp").iterdir())
    jargv = [*flags, "-i", str(ref / "index_u.npz"), str(ref / "index_d.npz")]
    _run_child(f"from cammiq_tpu.cli import main; main({jargv!r})", tmp_path, jax=True)
    _assert_same_build_files(ours, ref)


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


def _tree_files(d):
    """Every file under ``d``: .npy arrays as (dtype, shape, bytes), the
    rest as bytes."""
    out = {}
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if name.endswith(".npy"):
            a = np.load(path)
            out[name] = (a.dtype.str, a.shape, a.tobytes())
        else:
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def test_merged_artifact_cli_matches_jax_cli(pair_toy, tmp_path):
    """``cli --build --merged DIR`` by both packages (the numpy engine, on
    the CPU) writes the same artifact and meta files, and ``cli --query -i
    DIR`` (the artifact path: ``QuerySession.from_artifact``) in Type-I
    and Type-II mode writes ``cammiq_tpu.cli``'s files byte for byte, and
    in quant mode its abundances within 1e-3 L1."""
    _, mapf, db, _, fq = pair_toy
    merged = {}
    for who, main in (("port", lambda argv: cli_main(["--device", "cpu", *argv])),
                      ("jax", jax_cli_main)):
        d = tmp_path / who
        main(["--build", *BUILD_FLAGS, "-f", mapf, "-D", db, "--engine", "numpy",
              "-i", str(d / "index_u.npz"), str(d / "index_d.npz"),
              "--merged", str(d / "merged")])
        merged[who] = d / "merged"
    want = _tree_files(merged["jax"])
    assert "meta.json" in want and _tree_files(merged["port"]) == want
    base = ["--query", "-f", mapf, "-i", str(merged["jax"]), "-q", fq, "-e", "0.01"]
    for mode in ([], ["--read_cnts"], ["--read_cnts", "--doubly_unique"]):
        ours, ref = tmp_path / "ours.out", tmp_path / "ref.out"
        cli_main(["--device", "cpu", *base, *mode, "-o", str(ours)])
        jax_cli_main([*base, *mode, "-o", str(ref)])
        if mode:
            assert ours.read_bytes() == ref.read_bytes(), mode
            assert ours.read_text().startswith("QUERY/TAXID\t1000\t1001")
        else:
            got = {t: a for t, a, _ in parse_quant_output(str(ours))[0]["rows"]}
            exp = {t: a for t, a, _ in parse_quant_output(str(ref))[0]["rows"]}
            assert sorted(got) == sorted(exp) and len(exp) > 0
            assert sum(abs(got[t] - exp[t]) for t in exp) <= 1e-3
