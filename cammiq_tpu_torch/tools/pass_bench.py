"""Time steady-state query passes of one checkout of the port on the card.

    python cammiq_tpu_torch/tools/pass_bench.py --repo DIR --merged DIR \\
        [--passes 5] [--grid]
    python cammiq_tpu_torch/tools/pass_bench.py --repo DIR --engine gather \\
        --npz DIR [--passes 5]

Imports ``cammiq_tpu_torch`` from ``--repo`` (any checkout of the port, so
two versions can be timed in turns on one card, e.g. parent, change,
change, parent) and opens a session: the sort join on the merged artifact
at ``--merged``, or with ``--engine gather`` the gather engine on the
``index_u.npz`` / ``index_d.npz`` pair in ``--npz`` (the config-#3 ones
``chip_smoke.py`` builds into ``bench_cache/``).  It samples the reads
``chip_smoke.py`` samples (16 batches of 8192 from the bench generator,
seed 1).  With the gather engine it first holds ``gather_probe`` on the
first batch to its plain version and times it, device only (``device_ms``),
also with both tables inside the L2 (``probe_times``).
Then it warms up with one pass of each mode and times ``--passes`` quant
and sc-mode passes in turns (host clock around ``QuerySession.run``, which
ends in its blocking transfer).  Then it holds ``case_count`` on the first
batch's slots (the engine's own width) to its plain version and times it:
device only, wrapper included, and each of the wrapper's host steps
(``case_count_times``).  The sort join, where the checkout has
``kernels/match_assemble.py``, also holds ``match_assemble`` on the first
batch's match list to its plain version and times both
(``match_assemble_times``).  Last, one more pass of each mode under
``torch.profiler`` (``profile_pass``).  With ``--grid`` the sort join's
artifact is also opened as a world-of-one NCCL grid (``QuerySession(grid=
ProcessGrid(1, 1))``, the store on 127.0.0.1), whose passes are timed in
turns with the single session's and profiled the same way.  Prints one
JSON line: the checkout, the card, the session start, each pass's
seconds, the median reads/s by mode, the kernels' times and the profiles.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def device_ms(fn, calls: int = 20, reps: int = 3) -> float | None:
    """Device time of one call without the host's issue cost: a sleep
    kernel holds the stream while the host enqueues `calls` calls, so the
    CUDA events time them back to back on the device.  Median of `reps`;
    None when the host could not enqueue the calls within the sleep."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    sleep_s = 4 * enqueue_s + 1e-3
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * 2e9))       # >= sleep_s below 2 GHz
        t = time.perf_counter()
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        queued = time.perf_counter() - t < sleep_s
        e.synchronize()
        if queued:
            times.append(s.elapsed_time(e) / calls)
    return statistics.median(times) if times else None


def profile_pass(run) -> dict:
    """``run()`` (a warm pass) under torch.profiler: its wall time, the
    device's busy time, its number of device operations (kernels, copies,
    memsets) and the device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_ms": wall_ms,
            "device_ms": sum(e.self_device_time_total for e in dev) / 1e3,
            "device_ops": sum(e.count for e in dev),
            "lines": [f"{e.self_device_time_total / 1e3:.3f} ms {e.count}x "
                      f"{e.key[:120]}" for e in dev]}


def probe_times(sess, reads, reps: int) -> dict:
    """``gather_probe`` on the session's tables and the first batch: equal
    to its plain version, and its device-only ms, `reps` times; also with
    the doubly table in both roles (both tables inside the L2), which
    leaves out the unique table's DRAM walks."""
    import torch

    from cammiq_tpu_torch.kernels import gather_probe as kgp

    dev = sess.didx_u.device
    codes = torch.from_numpy(reads.codes[:8192]).to(dev).contiguous()
    lengths = torch.from_numpy(reads.lengths[:8192]).to(dev)
    args = (sess.didx_u, sess.didx_d, codes, lengths)
    got, want = kgp.gather_probe(*args), kgp.gather_probe_plain(*args)
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    del want
    l2 = (sess.didx_d, sess.didx_d, codes, lengths)
    return {"probe_equals_plain": equal,
            "probe_device_ms": [device_ms(lambda: kgp.gather_probe(*args))
                                for _ in range(reps)],
            "probe_l2_tables_device_ms": [device_ms(lambda: kgp.gather_probe(*l2))
                                          for _ in range(reps)]}


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of ``fn`` over `calls` back-to-back calls
    (``time.perf_counter_ns``), after a warm-up call; the device is
    synchronised before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    us = (time.perf_counter_ns() - t) / calls / 1e3
    torch.cuda.synchronize()
    return us


def batch_slots(sess, reads):
    """The first batch's match slots as the session's engine gives them
    to ``case_count``, with its lengths."""
    import torch

    dev = sess.device
    codes = torch.from_numpy(reads.codes[:8192]).to(dev).contiguous()
    lengths = torch.from_numpy(reads.lengths[:8192]).to(dev)
    if sess.engine == "gather":
        from cammiq_tpu_torch.query import classify as gc

        return gc.collect_matches(sess.didx_u, sess.didx_d, codes, lengths), lengths
    from cammiq_tpu_torch.query.sortjoin import collect_matches

    return collect_matches(sess.dm, codes, lengths, sess.maxm, sess.frac).slots, lengths


def match_assemble_times(sess, reads, reps: int) -> dict | None:
    """``match_assemble`` on the first batch's match list at the session's
    ``maxm`` and list capacity (as ``collect_matches`` calls it): equal to
    its plain version; device-only ms `reps` times, also with the list's
    count set to 0 (the launch's fixed cost: the launch, the barriers,
    every slot written empty), and ms a call wrapper included (host clock
    over 1000 calls), with the launch geometry and, counted on the host
    from ``mrow``, the reads holding more matches than 4 a lane (those
    that leave the group path: past a read's bucket, or in the kernel's
    counting-sort design past a group's stage) and the most a read holds.  None where the checkout has no such kernel."""
    import numpy as np
    import torch

    try:
        from cammiq_tpu_torch.kernels import match_assemble as kma
    except ImportError:
        return None
    from cammiq_tpu_torch.kernels.cuckoo_verify import cuckoo_verify
    from cammiq_tpu_torch.kernels.probe_bloom import num_offsets, probe_bloom
    from cammiq_tpu_torch.query.sortjoin import match_capacity

    dm = sess.dm
    codes = torch.from_numpy(reads.codes[:8192]).to(dm.device).contiguous()
    lengths = torch.from_numpy(reads.lengths[:8192]).to(dm.device)
    B, Lp = codes.shape
    O = num_offsets(Lp, dm.h)
    rows, keys, n = probe_bloom(codes, dm.bloom, dm.h, dm.bloom_log)
    mrow, me, counts = cuckoo_verify(
        rows, keys, n, codes, lengths, dm.cuckoo, dm.cuckoo_log, dm.erec,
        dm.n_colors, match_capacity(B * O, dm.n_colors, sess.frac))
    args = (mrow, me, counts, dm.prec, O, B, sess.maxm, dm.eu)
    got, want = kma.match_assemble(*args), kma.match_assemble_plain(*args)
    call = lambda: kma.match_assemble(*args)  # noqa: E731
    none = (mrow, me, torch.zeros_like(counts), *args[3:])
    geometry = kma.match_assemble_geometry(mrow.shape[0], B, sess.maxm, dm.device)
    rows = mrow[:min(int(counts[0]), mrow.shape[0])].cpu().numpy()
    held = np.bincount(rows[(rows >= 0) & (rows < B * O)] // O, minlength=B)
    return {"shape": [mrow.shape[0], B, sess.maxm], "matches": int(counts[0]),
            "reads_past_4_a_lane": int((held > 4 * geometry["lanes"]).sum()),
            "most_matches_a_read": int(held.max()),
            "equals_plain": all(torch.equal(g, w) for g, w in zip(got, want)),
            "device_ms": [device_ms(call) for _ in range(reps)],
            "no_matches_device_ms": [device_ms(lambda: kma.match_assemble(*none))
                                     for _ in range(reps)],
            "wrapper_ms": host_us(call) / 1e3,
            "geometry": geometry}


def time_passes(sessions: dict, reads, passes: int) -> dict:
    """Seconds of ``passes`` quant and sc passes of each session, after one
    warm-up pass of each, the sessions and modes in turns: name -> mode ->
    [s]."""
    import torch

    out = {name: {"quant": [], "sc": []} for name in sessions}
    for i in range(passes + 1):
        order = list(sessions.items())
        for name, sess in (order if i % 2 else order[::-1]):
            for mode in (("quant", "sc") if i % 2 else ("sc", "quant")):
                torch.cuda.synchronize()
                t = time.perf_counter()
                sess.run(reads, sc_mode=mode == "sc")
                if i:                          # pass 0 warms up
                    out[name][mode].append(time.perf_counter() - t)
    return out


def profiles(sess, reads) -> dict:
    """One profiled pass of each mode (``profile_pass``), the table cut to
    its first ten lines."""
    out = {}
    for mode in ("quant", "sc"):
        prof = profile_pass(lambda: sess.run(reads, sc_mode=mode == "sc"))
        out[mode] = {**prof, "lines": prof["lines"][:10]}
    return out


def grid_session(art, device):
    """The artifact as a world-of-one NCCL grid's session (the process
    group started here, on a free port of 127.0.0.1)."""
    import datetime
    import socket

    import torch.distributed as dist

    from cammiq_tpu_torch.config import QueryConfig
    from cammiq_tpu_torch.parallel.mesh import ProcessGrid
    from cammiq_tpu_torch.query.pipeline import QuerySession
    from cammiq_tpu_torch.tools.benchdata import BENCH_GENOMES

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    return QuerySession.from_artifact(
        art, BENCH_GENOMES + 1, QueryConfig(h=art.h, erate=0.01, batch_size=8192),
        device=device, grid=ProcessGrid(1, 1, device))


def case_count_times(sess, reads, reps: int) -> dict:
    """``case_count`` on the first batch's slots, in quant mode with the
    session's rcount target and counter buffer (as a pass calls it): equal
    to its plain version in quant and sc mode; device-only ms `reps`
    times; ms a call wrapper included (host clock over 1000 calls); the
    host microseconds of each of the wrapper's steps (the stream handle
    and the pair pointers also in their slower forms, through a Stream
    object and two row views; the ctypes call with its 18 arguments
    packed into one buffer where the checkout packs them); and the launch
    geometry where the checkout reports one."""
    import torch

    from cammiq_tpu_torch.kernels import build
    from cammiq_tpu_torch.kernels import case_count as kcc

    ms, lengths = batch_slots(sess, reads)
    dev, G = lengths.device, sess.num_genome_slots
    B = lengths.shape[0]
    equal = True
    for sc in (False, True):
        outs = []
        for fn in (kcc.case_count, kcc.case_count_plain):
            rc = torch.zeros(sess._rc_size, dtype=torch.int32, device=dev)
            outs.append((*fn(ms, lengths, G, sc_mode=sc, rcounts=((rc, 0),)), rc))
        equal &= all(torch.equal(a, b) for a, b in zip(*outs))
    rc = torch.zeros(sess._rc_size, dtype=torch.int32, device=dev)
    counts = torch.zeros(2 * G + 2, dtype=torch.int32, device=dev)
    call = lambda: kcc.case_count(ms, lengths, G, rcounts=((rc, 0),),  # noqa: E731
                                  counts=counts)
    out = {"shape": list(ms.slots.shape), "equals_plain": bool(equal),
           "device_ms": [device_ms(call) for _ in range(reps)],
           "wrapper_ms": host_us(call) / 1e3}
    geometry = getattr(kcc, "case_count_geometry", None)
    if geometry is not None:
        out["geometry"] = geometry(ms.slots)
    pairs = torch.empty(2, B, dtype=torch.int32, device=dev)
    args = (ms.slots.data_ptr(), ms.rid1.data_ptr(), ms.rid2.data_ptr(),
            lengths.data_ptr(), B, ms.slots.shape[1], G, 0, counts.data_ptr(),
            pairs.data_ptr(), pairs.data_ptr() + 4 * B, rc.data_ptr(), 0,
            rc.shape[0], 0, 0, 0, build.stream_ptr(dev))
    pack = getattr(kcc, "_pack", None)      # the 18 arguments as one buffer
    tensors = (ms.slots, ms.rid1, ms.rid2, lengths, rc, counts)
    steps = {
        "check_tensor x6": lambda: [build.check_tensor(t, "t", torch.int32, dev)
                                    for t in tensors],
        "torch.empty(2, B)": lambda: torch.empty(2, B, dtype=torch.int32, device=dev),
        "pairs[0].data_ptr(), pairs[1].data_ptr()":
            lambda: (pairs[0].data_ptr(), pairs[1].data_ptr()),
        "pairs.data_ptr() + 4 B": lambda: (pairs.data_ptr(), pairs.data_ptr() + 4 * B),
        "current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "stream_ptr(dev)": lambda: build.stream_ptr(dev),
        "the ctypes call and launch": (lambda: kcc.KERNEL(pack(*args))) if pack
        else (lambda: kcc.KERNEL(*args)),
        "the returned views": lambda: kcc._views(counts, G, pairs[0], pairs[1]),
        "whole wrapper": call,
    }
    out["wrapper_steps_us"] = {k: host_us(f) for k, f in steps.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", required=True, help="checkout to import the port from")
    ap.add_argument("--engine", choices=("sortjoin", "gather"), default="sortjoin")
    ap.add_argument("--merged", help="merged artifact directory (sort join)")
    ap.add_argument("--npz", help="directory of index_u.npz and index_d.npz (gather)")
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--grid", action="store_true",
                    help="also time the sort join as a world-of-one NCCL grid")
    args = ap.parse_args(argv)
    if (args.engine == "gather") != (args.npz is not None) or \
            (args.engine == "sortjoin") != (args.merged is not None):
        ap.error("the sort join takes --merged, the gather engine --npz")
    if args.grid and args.engine != "sortjoin":
        ap.error("--grid times the sort join")
    repo = os.path.abspath(args.repo)
    sys.path[0] = repo      # not this file's directory: the port comes from --repo

    import numpy as np
    import torch

    from cammiq_tpu_torch.config import QueryConfig
    from cammiq_tpu_torch.io.fastq import ReadSet
    from cammiq_tpu_torch.query.pipeline import QuerySession
    from cammiq_tpu_torch.tools.benchdata import (BENCH_GENOMES, BENCH_GLEN,
                                                  gen_genomes, sample_read_batch)

    if not torch.cuda.is_available():
        print("pass_bench: no CUDA device", file=sys.stderr)
        return 2
    genomes = gen_genomes(BENCH_GENOMES, BENCH_GLEN)
    rng = np.random.default_rng(1)
    parts = [sample_read_batch(rng, genomes, 8192) for _ in range(16)]
    del genomes
    lengths = np.concatenate([p[1] for p in parts])
    reads = ReadSet(codes=np.concatenate([p[0] for p in parts]), lengths=lengths,
                    total_len=int(lengths.sum()), name="bench")
    t = time.perf_counter()
    if args.engine == "gather":
        from cammiq_tpu_torch.index.table import load_flat_index_pair

        index_u, index_d = load_flat_index_pair(os.path.join(args.npz, "index_u.npz"),
                                                os.path.join(args.npz, "index_d.npz"))
        sess = QuerySession(index_u, index_d, BENCH_GENOMES + 1,
                            QueryConfig(h=index_u.h, erate=0.01, batch_size=8192),
                            device="cuda", engine="gather")
    else:
        from cammiq_tpu_torch.index.artifact import load_merged_artifact

        art = load_merged_artifact(args.merged)
        sess = QuerySession.from_artifact(
            art, BENCH_GENOMES + 1, QueryConfig(h=art.h, erate=0.01, batch_size=8192),
            device="cuda")
    torch.cuda.synchronize()
    result = {"repo": repo, "device": torch.cuda.get_device_name(0),
              "engine": args.engine, "session_start_s": time.perf_counter() - t}
    if args.engine == "gather":
        result.update(probe_times(sess, reads, reps=5))
    sessions = {"single": sess}
    if args.grid:
        sessions["grid"] = grid_session(art, sess.device)
    passes = time_passes(sessions, reads, args.passes)
    result.update(pass_s=passes["single"], reads_per_s={
        m: reads.num_reads / statistics.median(p) for m, p in passes["single"].items()})
    result["case_count"] = case_count_times(sess, reads, reps=5)
    if args.engine == "sortjoin":
        result["match_assemble"] = match_assemble_times(sess, reads, reps=5)
    result["profile"] = profiles(sess, reads)
    if args.grid:
        result["grid"] = {"pass_s": passes["grid"],
                          "profile": profiles(sessions["grid"], reads)}
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
