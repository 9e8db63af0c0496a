"""The harness on the card at a tiny size: the port's kernels against the
reference, the sampler's determinism, and the reference on the card against
the reference on the CPU.  Run on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda perfbench
"""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import genomes, harness
from perfbench.reference.classify import classify
from perfbench.reference.index import check_index, load_rows, probe_rows
from perfbench.system import ensure_index

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "testdata")
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("perfbench_cuda_cache"))


def _bench(cfg, mode):
    return {"configs": [{"name": cfg, "file": f"perfbench/testdata/{cfg}.json"}],
            "workloads": [{"name": "t", "config": cfg, "traffic": f"tiny-{mode}",
                           "chips": 1}],
            "end_to_end": [{"name": "reads_per_s", "unit": "reads/s"},
                           {"name": "device_ms_per_mread", "unit": "ms/Mread"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": n, "unit": "u"} for n in
                          ("pass_ms", "device_ops_per_batch", "idle_pct",
                           "case_count_roofline", "reads_per_s.type2")]}


@pytest.mark.parametrize("cfg,mode", [("tiny", "quant"), ("tiny-gather", "type1"),
                                      ("tiny", "type2")])
def test_cell_on_the_card(card, cache, cfg, mode):
    out = harness.run_cell(_bench(cfg, mode), "t", 2**31 + 17, 0.5, True, card,
                           0.0, cache, log=lambda m: None, traffic_dir=DATA)
    assert out["correct"], out["compared"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["case_count_roofline"]["value"] <= 105
    assert out["metrics"]["reads_per_s.type2"]["value"] > 0


def test_window_device_time_on_the_card(card, cache):
    """The untraced run profiles every window sample's device activity: its
    busy milliseconds a million reads are above 0 and below the window's
    whole time a million reads."""
    out = harness.run_cell(_bench("tiny", "type2"), "t", 2**31 + 19, 0.5, False,
                           card, 0.0, cache, log=lambda m: None, traffic_dir=DATA)
    assert out["correct"], out["compared"]
    m = out["metrics"]
    assert set(m) == {"reads_per_s", "device_ms_per_mread", "setup_s"}
    wall_ms_per_mread = 1e3 / (m["reads_per_s"]["value"] / 1e6)
    assert 0 < m["device_ms_per_mread"]["value"] < wall_ms_per_mread


def test_sampler_is_deterministic_on_the_card(card):
    codes = torch.from_numpy(genomes.genome_codes(genomes.gen_genomes(6, 3000, 2))).to(card)
    def draw():
        gen = torch.Generator(device=card).manual_seed(2**31 + 1)
        ids, w = genomes.draw_community(gen, 6, 3, 1.0)
        return genomes.draw_reads(gen, codes, ids, w, 20000, 100, 0.01, 0.5, chunk=4096)

    a, b = draw(), draw()
    assert np.array_equal(a, b)


def test_reference_on_the_card_equals_the_cpu(card, cache):
    cfg = json.load(open(os.path.join(DATA, "tiny.json")))
    index_dir, codes = ensure_index(cfg, cache, "cpu", lambda m: None)
    g = np.load(codes)
    gen = torch.Generator().manual_seed(5)
    ids, w = genomes.draw_community(gen, g.shape[0], 4, 1.0)
    reads = genomes.draw_reads(gen, torch.from_numpy(g), ids, w, 3000, 100, 0.01, 0.5)
    outs = []
    for dev in ("cpu", card):
        rows = load_rows(index_dir, cfg["build"]["Lmax"], torch.device(dev))
        idx = check_index(rows, torch.from_numpy(g).to(dev), cfg["build"]["L"])
        lm = idx.pop("lmers")
        outs.append((idx, lm, classify(probe_rows(rows), reads, 9, dev)))
    (i0, l0, c0), (i1, l1, c1) = outs
    assert i0 == i1 and i0["bad_rows"] == 0
    for k in ("nus", "nds"):
        assert all(np.array_equal(a, b) for a, b in zip(l0[k], l1[k])), k
    for k in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
        assert np.array_equal(c0[k], c1[k]), k
    assert c0["pair_counts"] == c1["pair_counts"]
