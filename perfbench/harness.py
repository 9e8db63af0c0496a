"""One run of one cell: set-up, the measured window, the traced sample, the
comparison with the reference, and the result line.

The cell's configuration, traffic mix and per-layer metrics are found by
their names in ``BENCHMARK.json``: ``configs/<name>.json`` (the file the
configuration's entry names), ``traffic/<name>.json`` and
``metrics/<name>.py`` (a ``read(ctx)`` that returns the value or None).

The window is a closed loop of samples: a lab's queue runs the next sample
when the last is written.  A sample is ``traffic["reads_per_sample"]``
reads of one of the traffic's ``traffic["pool"]`` communities, drawn from
the seed (``draw_pool``); the window runs the pool in turn until
``--seconds`` have passed, the last sample included.  ``reads_per_s`` is
every read of the samples completed over the whole window;
``device_ms_per_mread``, in a cell that lists it, the device's busy
milliseconds over all the window's samples (each run under the device's
activity alone) a million of their reads.  ``setup_s`` runs from the
process's start to the window's: imports, the index (built on a cell's
first run in a checkout, loaded after), the session, the samples, and a
warm-up of every pool sample's pass and one whole sample, which settles the
session's sticky widening.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

from . import compare, genomes
from .modcheck import forbidden_modules

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(bench: dict, workload: str, root: str = ROOT,
              traffic_dir: str = os.path.join(HERE, "traffic")):
    """(cell, configuration, traffic, its end-to-end and per-layer
    metrics); ``SystemExit`` for an unknown cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(traffic_dir, f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return cell, cfg, traffic, e2e, layer


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    """What a per-layer metric reader reads."""

    def __init__(self, mode, cfg, traffic, samples, trace, per_batch,
                 reads=0, window_s=0.0):
        self.mode = mode
        self.G = cfg["corpus"]["genomes"] + 1
        self.read_len = traffic["read_len"]
        self.samples = samples          # spans of each sample in the window
        self.trace = trace              # profile_trace.Trace of one sample
        # the reference's [[matches, assigned matches, reads], ...] of each
        # of the traced sample's batches
        self.per_batch = per_batch
        self.batches = len(per_batch)
        self.reads = reads              # reads completed in the window
        self.window_s = window_s        # the window, host clock

    def median_span(self, key):
        vals = [s[key] for s in self.samples if key in s]
        return statistics.median(vals) if vals else None

    def device_ops(self):
        return self.trace.device if self.trace is not None else []


def card() -> dict:
    import torch

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        limit = r.stdout.strip().splitlines()[0] if r.returncode == 0 else "n/a"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        limit = "n/a"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "power_limit": limit}


def draw_pool(traffic: dict, codes_path: str, seed: int, device: str) -> list:
    """The run's samples (``ReadSet``s named ``sample<k>``) on ``device``.
    Their communities are the traffic's own (drawn from its
    ``communities_seed``), so every seed has the same work; ``seed`` draws
    each sample's reads and the order in which the pool runs."""
    import torch

    from .system import read_set

    gcodes = torch.from_numpy(np.load(codes_path)).to(device)
    fixed = torch.Generator(device=device).manual_seed(traffic["communities_seed"])
    communities = [genomes.draw_community(fixed, gcodes.shape[0], traffic["present"],
                                          traffic["abundance_sigma"])
                   for _ in range(traffic["pool"])]
    gen = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(len(communities), generator=gen, device=device).tolist()
    return [read_set(genomes.draw_reads(
        gen, gcodes, *communities[c], traffic["reads_per_sample"],
        traffic["read_len"], traffic["erate"], traffic["rc_frac"]),
        compare.sample_name(k)) for k, c in enumerate(order)]


def quant_answers(refs: dict, rows: dict, lmers: dict, cfg: dict,
                  traffic: dict, log) -> None:
    """The reference's quant answer of each sample, into ``refs[k]["quant"]``.
    ``lmers``: the bounds of the genomes' unique L-mer counts that the
    index check derived from the database (``index.lmer_bounds``)."""
    from .reference.answers import quant_candidates
    from .reference import quant

    G = cfg["corpus"]["genomes"] + 1
    eu = rows["eu"]
    fields = ("rid1", "rid2", "ucount1", "ucount2", "length")
    pu = {f: rows[f][:eu].cpu().numpy() for f in fields}
    pd = {f: rows[f][eu:].cpu().numpy() for f in fields}
    glength = np.full(G, cfg["corpus"]["genome_length"], np.int64)
    glength[0] = 0
    for k, ref in refs.items():
        cand, easy = quant_candidates(ref["cnts_u"], ref["cnts_d"], lmers)
        args = (pu, pd, ref["rcount_u"], ref["rcount_d"], ref["cnts_u"],
                ref["cnts_d"], cand, easy, glength, traffic["read_len"],
                traffic["reads_per_sample"], cfg["query"]["erate"])
        max_cov = cfg["query"].get("max_depth", 100.0)
        exist, ab, val = quant.solve(*args, max_cov=max_cov)
        ref["quant"] = (exist, ab)
        log(f"sample{k}: {int(cand.sum())} candidates, reference EXIST "
            f"{np.nonzero(exist)[0].tolist()}, objective {val!r}")
        if cand.any():
            ref["quant_model"] = (quant.model(*args, max_cov=max_cov)[0],
                                  np.nonzero(cand)[0])


def log_quant_answers(results, refs: dict, log) -> None:
    """The program's first answer of each sample under the reference's
    model: its objective and whether it meets every constraint (a reading
    for the record; ``compare`` judges the answer)."""
    seen = set()
    for k, res in results:
        if k in seen or "quant_model" not in refs[k]:
            continue
        seen.add(k)
        qp, surv = refs[k]["quant_model"]
        c = np.where(np.asarray(res.exist, bool)[surv], res.cov[surv], 0.0)
        log(f"sample{k}: program's answer under the model: objective "
            f"{qp.objective(c)!r}, feasible {qp.feasible(c)}")


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, cache_root: str, log=None,
             traffic_dir: str = os.path.join(HERE, "traffic")) -> dict:
    """One run; returns the result line's object (``compared`` last)."""
    import torch

    from .profile_trace import breakdown, device_busy, traced
    from .reference.classify import classify
    from .reference.index import check_index, load_rows, probe_rows
    from .system import System, ensure_index

    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell, cfg, traffic, e2e, layer = load_cell(bench, workload,
                                               traffic_dir=traffic_dir)
    mode = traffic["mode"]
    c = cfg["corpus"]
    G = c["genomes"] + 1
    on_card = device == "cuda"
    # the device's busy time over the window, where the cell reports it
    busy_e2e = on_card and not trace and any(
        m["name"] == "device_ms_per_mread" for m in e2e)

    def sample(rs):
        if not busy_e2e:
            return system.run_sample(rs), 0.0, 0
        return device_busy(lambda: system.run_sample(rs))

    # ---- set-up
    index_dir, codes_path = ensure_index(cfg, cache_root, device, log)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pool = draw_pool(traffic, codes_path, seed, device)
    system = System(cfg, index_dir, mode, device)
    batch = system.sess.batch_size(pool[0])
    for rs in pool[1:]:
        system.sess.run(rs, sc_mode=mode == "type2", with_rcounts=mode == "quant")
    sample(pool[0])     # settles the widening; starts the profiler once
    if on_card:
        torch.cuda.synchronize()

    # ---- the window
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    results, ends, busy_s, ops = [], [], 0.0, 0
    while True:
        k = len(results) % len(pool)
        res, busy, n = sample(pool[k])
        results.append((k, res))
        busy_s += busy
        ops += n
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    reads = sum(pool[k].num_reads for k, _ in results)
    q = statistics.quantiles(np.diff(ends, prepend=0.0) * 1e3, n=10) if len(ends) > 1 else []
    log(f"window: {len(results)} samples, {reads} reads in {window_s:.3f} s; "
        f"set-up {setup_s:.3f} s; sample ms p10/p50/p90 "
        f"{' / '.join(f'{x:.1f}' for x in q[::4])}")
    if busy_e2e:
        log(f"window's device: busy {busy_s:.6f} s, {ops} operations "
            f"({ops / len(results):.1f} a sample)")

    tr = None
    if trace:
        def span(name):
            return torch.profiler.record_function(f"pb.{name}")

        res0, tr = traced(lambda: system.run_sample(pool[0], span))
        results.append((0, res0))
        log(f"traced sample: {len(tr.device)} device operations, "
            f"{tr.wall_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    system.close()
    del system
    gc.collect()

    # ---- the reference, on the device the program used, its state freed
    t = time.perf_counter()
    dev = torch.device(device)
    rows = load_rows(index_dir, cfg["build"]["Lmax"], dev)
    idx = check_index(rows, torch.from_numpy(np.load(codes_path)).to(dev),
                      cfg["build"]["L"])
    lmers = idx.pop("lmers")
    prow = probe_rows(rows)
    del rows
    used = sorted({k for k, _ in results})
    refs = {k: classify(prow, pool[k].codes, G, dev,
                        matches_per_batch=batch if trace and k == 0 else None)
            for k in used}
    if mode == "quant":
        quant_answers(refs, prow, lmers, cfg, traffic, log)
    del prow
    if mode == "quant":
        log_quant_answers(results, refs, log)
    judged = compare.judge(mode, results, refs, idx)
    numbers = judged["numbers"]
    correct = compare.verdict(numbers)
    log(f"reference: {time.perf_counter() - t:.1f} s; index {idx}")

    if trace:
        ctx = Ctx(mode, cfg, traffic, [r.spans for _, r in results[:-1]], tr,
                  refs[0].get("matches_per_batch", []), reads, window_s)
        metrics = {}
        for m in layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"reads_per_s": reads / window_s, "setup_s": setup_s}
        if busy_e2e:
            values["device_ms_per_mread"] = busy_s * 1e3 / (reads / 1e6)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] in values}
    dev_info = card() if on_card else {"platform": "cpu", "kind": "cpu",
                                       "count": 1}
    dev_info["memory_peak_bytes"] = peak
    out = {"correct": correct, "attempted": len(results),
           "failed": judged["bad_samples"], "metrics": metrics,
           "device": dev_info}
    if trace and tr is not None:
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = tr.wall_s
        out["breakdown"] = breakdown(tr)
    out["samples_run"] = {"window": len(results) - int(trace),
                          "reads": reads, "window_s": window_s}
    out["compared"] = {k: {"value": v, "limit": compare.LIMITS[k]}
                       for k, v in numbers.items()}
    return out


def main(argv=None, t_start=None) -> int:
    t_start = t_start or time.time()
    a = parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = load_cell(bench, a.workload)[0]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cache_root = os.path.join(HERE, "cache")
    os.makedirs(cache_root, exist_ok=True)
    # build caches at fixed paths inside the checkout (the port builds its
    # kernels into its own cammiq_tpu_torch/_build/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(cache_root, sub)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out = run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                   t_start, cache_root)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    for k, v in out["compared"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
