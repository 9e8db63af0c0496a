"""The frozen generator, the vectorised sampler's mixture, the work-counted
bounds on a hand-computed batch, and the trace arithmetic (CPU)."""

import numpy as np
import pytest
import torch

from perfbench import bounds, genomes
from perfbench.profile_trace import Trace, breakdown


def test_gen_genomes_is_the_bench_generator():
    from cammiq_tpu_torch.tools.benchdata import gen_genomes

    assert genomes.gen_genomes(5, 4000, seed=3) == gen_genomes(5, 4000, seed=3)


def _sample(seed, erate=0.0):
    codes = torch.from_numpy(genomes.genome_codes(genomes.gen_genomes(12, 3000, 1)))
    gen = torch.Generator().manual_seed(seed)
    ids, w = genomes.draw_community(gen, 12, 4, 1.0)
    return codes, genomes.draw_reads(gen, codes, ids, w, 5000, 100, erate, 0.5,
                                     chunk=1024)


def _source(codes, read):
    """Genome ids (0-based) whose sequence holds ``read`` on either strand."""
    s = "".join("ACGT"[c] for c in read)
    rc = "".join("ACGT"[c] for c in (3 - read)[::-1])
    out = set()
    for g in range(codes.shape[0]):
        t = "".join("ACGT"[c] for c in codes[g].tolist())
        if s in t or rc in t:
            out.add(g)
    return out


def test_draw_reads_mixture_shape():
    codes, r = _sample(2**31 + 5)
    assert r.shape == (5000, 100) and r.dtype == np.int8 and r.min() >= 0 and r.max() <= 3
    again = _sample(2**31 + 5)[1]
    assert np.array_equal(r, again), "the same seed gives the same reads"
    assert not np.array_equal(r, _sample(7)[1])
    # error-free reads come from at most `present` genomes, both strands
    srcs = [_source(codes, r[i]) for i in range(0, 5000, 125)]
    assert all(srcs), "every read is a substring of some genome"
    used = set.union(*srcs)
    assert 1 <= len(used) <= 4 + 2  # shared segments may name two more
    fwd = sum(any("".join("ACGT"[c] for c in r[i]) in
                  "".join("ACGT"[c] for c in codes[g].tolist()) for g in s)
              for i, s in zip(range(0, 5000, 125), srcs))
    assert 8 <= fwd <= 32, "about half reverse-complemented"


def test_draw_reads_substitutions():
    codes, clean = _sample(9)
    _, noisy = _sample(9, erate=0.04)
    # the same draws up to the substitution step: differences at ~3/4 of
    # the substituted bases (a uniform base may be the same one)
    rate = float((clean != noisy).mean())
    assert 0.02 < rate < 0.04


def test_bounds_on_a_hand_computed_batch():
    # 8192 reads of 100 bases, 12,895 matches, 12,000 of assigned reads
    assert bounds.probe_bytes(8192, 100, 12895) == 8192 * 104 + 12895 * 36
    assert bounds.case_count_bytes(8192, 12895, 12000, 1001) == (
        16 * 12895 + 4 * 8192 + 4 * 2004 + 8 * 12000)
    assert bounds.bound_s(3.35e12) == pytest.approx(1.0)
    assert bounds.bound_s(bounds.probe_bytes(8192, 100, 12895)) == pytest.approx(
        1316188 / 3.35e12)


def test_trace_arithmetic():
    dev = [("k1", 0, 10), ("k2", 5, 20), ("Memcpy DtoH (Device -> Pageable)", 30, 40),
           ("k1", 70, 80)]
    host = [("pb.pass", -5, 100), ("aten::copy_", 20, 45), ("aten::sum", 45, 90)]
    t = Trace(device=dev, host=host, wall_s=100e-6)
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.by_name()["k1"] == pytest.approx(20e-6)
    assert t.seconds("Memcpy DtoH") == pytest.approx(10e-6)
    gaps = t.idle_gaps()
    assert gaps == pytest.approx({"pb.pass / aten::copy_": 10e-6,
                                  "pb.pass / aten::sum": 30e-6})
    b = breakdown(t)
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert len(b["idle_gaps"]) == 2
    # with the traced window known, its head and tail count too
    host = sorted(host + [("pb.solve", 82, 99)], key=lambda r: r[1])
    t = Trace(device=dev, host=host, wall_s=100e-6, span=(-5, 99))
    assert t.idle_gaps() == pytest.approx({"pb.pass / pb.pass": 5e-6,
                                           "pb.pass / aten::copy_": 10e-6,
                                           "pb.pass / aten::sum": 30e-6,
                                           "pb.solve / pb.solve": 19e-6})
