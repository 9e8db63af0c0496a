"""End to end through both CLIs on the test_e2e.py toy DB: the port
(`python -m cammiq_tpu_torch.cli --device cpu`) against `cammiq_tpu.cli`."""

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)

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
    cli_main(["--build", "--both", "-f", mapf, "-D", str(db) + "/", "-k", "20",
              "-L", "100", "-Lmax", "40", "-h", "20", "-i", iu, idd,
              "--engine", "numpy"])
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
        cli_main(["--device", "cpu", "--query", "--read_cnts",
                  "--doubly_unique", *args, "-o", str(root / "t2.out")])
    with pytest.raises(NotImplementedError):
        cli_main(["--device", "cpu", "--query", "-t", "2", *args,
                  "-o", str(root / "t.out")])
