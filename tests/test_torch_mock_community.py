"""A database whose genomes share segments pairwise, at a small size on the
CPU: about a tenth of the index is doubly-unique and the quant MIQP has a
C2 row for each of its candidates, where config #3's shape has almost
none.

The database is ``perfbench/genomes.py``'s generator at 60 genomes x 20 kb
with a pool of twice the genomes (each segment's other holders follow
Poisson(1)) and a quarter of each genome shared, seed 0, built by the
port's host engine with ``c3-sortjoin``'s build; two quant samples of 25
genomes run through the merged artifact and the sort join
(``perfbench.system.System``, the body of ``cli --query``) and are held
to ``perfbench/reference``: counts bit for bit, EXIST equal, abundances
within 1e-3 L1 (BASELINE.md:28).  The tracer's doubly spans in
``build_problem`` and ``solve_quant``'s counters are checked on the same
instances.
"""

import json
import os

import numpy as np
import pytest
import torch

import cammiq_tpu_torch.models.quant as mq
from cammiq_tpu_torch.config import BuildConfig
from cammiq_tpu_torch.index.builder import build_index, save_index
from cammiq_tpu_torch.io.fasta import corpus_from_sequences
from cammiq_tpu_torch.utils import timing
from perfbench import compare, genomes, harness
from perfbench.reference.classify import classify
from perfbench.reference.index import check_index, load_rows, probe_rows
from perfbench.system import System, ensure_index, index_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "perfbench", "configs", "c3-sortjoin.json")) as _f:
    CFG = json.load(_f)
CFG["corpus"].update(genomes=60, genome_length=20000, shared_pool=120,
                     shared_len_frac=0.25)
with open(os.path.join(ROOT, "perfbench", "traffic", "quant.json")) as _f:
    TRAFFIC = json.load(_f)
TRAFFIC.update(present=25, reads_per_sample=30000)
SEED = 2**31 + 21


@pytest.fixture(scope="module")
def community(tmp_path_factory):
    """The two samples' results, the problems and infos their solves saw,
    the reference's counts and answers, and the index check."""
    torch.set_num_threads(1)
    cache = str(tmp_path_factory.mktemp("mock_community"))
    c = CFG["corpus"]
    db = genomes.gen_genomes(c["genomes"], c["genome_length"], c["seed"],
                             c["shared_pool"], c["shared_len_frac"])
    out = os.path.join(cache, index_key(CFG))
    save_index(build_index(corpus_from_sequences(db), BuildConfig(**CFG["build"]),
                           engine="native"), out)
    np.save(os.path.join(out, "genomes.npy"), genomes.genome_codes(db))
    # the index is there, so this makes the merged artifact alone
    index_dir, codes_path = ensure_index(CFG, cache, "cpu", log=lambda m: None)
    pool = harness.draw_pool(TRAFFIC, codes_path, SEED, "cpu")
    assert len(pool) == 2

    solved = []
    solve_quant = mq.solve_quant

    def solve(prob, **kw):
        out = solve_quant(prob, **kw)
        solved.append((prob, out[2]))
        return out

    system = System(CFG, index_dir, "quant", "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mq, "solve_quant", solve)
        results = [(k, system.run_sample(rs)) for k, rs in enumerate(pool)]

    dev = torch.device("cpu")
    rows = load_rows(index_dir, CFG["build"]["Lmax"], dev)
    idx = check_index(rows, torch.from_numpy(np.load(codes_path)), CFG["build"]["L"])
    lmers = idx.pop("lmers")
    prow = probe_rows(rows)
    G = c["genomes"] + 1
    refs = {k: classify(prow, pool[k].codes, G, dev) for k in range(len(pool))}
    harness.quant_answers(refs, prow, lmers, CFG, TRAFFIC, log=lambda m: None)
    return {"system": system, "results": results, "solved": solved,
            "refs": refs, "idx": idx}


def test_port_matches_the_reference(community):
    judged = compare.judge("quant", community["results"], community["refs"],
                           community["idx"])
    n = judged["numbers"]
    assert n["index_bad_rows"] == 0 and n["counts_diff"] == 0, n
    assert n["answer_diff"] == 0, n
    assert n["abund_l1"] <= compare.LIMITS["abund_l1"], n
    assert judged["bad_samples"] == 0
    for k, res in community["results"]:
        ex, _ = community["refs"][k]["quant"]
        np.testing.assert_array_equal(np.asarray(res.exist, bool), ex)


def test_the_shape_keeps_its_point(community):
    """Pairwise sharing: a tenth of the index doubly-unique, and each
    sample's MIQP has doubly terms and at least 10 C2 rows."""
    idx = community["idx"]
    assert idx["doubly"] >= 0.05 * (idx["unique"] + idx["doubly"]), idx
    for prob, info in community["solved"]:
        assert len(prob.c2_species) >= 10 and len(prob.downer) > 0
        assert info["doubly_terms"] == len(prob.downer)


def test_solve_counters(community):
    for prob, info in community["solved"]:
        assert info["c2_rows"] == len(prob.c2_species)
        assert info["candidates"] == int(prob.exist0.sum())
        assert info["fista_chunks"] > 0


def _problem(system, counts):
    gl, nus, nds = system.table.arrays()
    return mq.build_problem(
        system.index_u, system.index_d, counts.rcount_u, counts.rcount_d,
        counts.cnts_u.astype(np.float64), counts.cnts_d.astype(np.float64),
        nus.astype(np.float64), nds.astype(np.float64), gl,
        counts.mean_read_len, counts.num_reads, system.erate, system.fine)


def test_doubly_spans_inside_their_parents(community):
    system = community["system"]
    counts = community["results"][0][1].counts
    timing.disable()
    timing.take()
    off = _problem(system, counts)
    rec = timing.take()
    assert rec.spans == [] and rec.folded == {}, "the tracer off records nothing"
    with timing.tracing():
        on = _problem(system, counts)
    rec = timing.take()
    for f in ("exist0", "downer", "dg1", "dg2", "dw1", "dw2", "dr", "df", "c2_species"):
        assert getattr(on, f).tobytes() == getattr(off, f).tobytes(), f
    by = {s.name: s for s in rec.spans}
    for child, parent in (("problem.doubly_sizes", "problem.entry_sizes"),
                          ("problem.doubly_weights", "problem.entry_weights"),
                          ("problem.doubly_terms", "problem.terms")):
        assert by[child].parent is by[parent]
        assert by[parent].parent is by["quant.build_problem"]
        assert by[child].ns <= by[parent].ns
