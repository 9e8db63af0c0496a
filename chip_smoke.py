#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cammiq_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (written for an H100), the CUDA toolkit (nvcc) and a
C++ compiler with OpenMP.  It builds everything from this checkout, imports
nothing of JAX or of the JAX package, and exits nonzero if any phase fails:

1. header: the card's name and power limit, torch/CUDA/nvcc versions; the
   eleven CUDA kernels and the native host library are compiled (build
   seconds printed);
2. set-up: the config-#3-shape index (the bench generator,
   tools/benchdata.py: 1000 genomes x 300 kb, k=26 L=100 Lmax=50 h=26),
   built by the port's build_index on cuda, saved, and made into the merged
   artifact by the port's prepare_merged, in the git-ignored bench_cache/.
   This is the build path: the launch counters are zeroed before the build
   and read after, and its stage seconds and peak device memory are
   printed;
3. kernels on the card: each query kernel against its plain PyTorch version
   on the same CUDA tensors at the main path's shapes (one batch of 8192
   reads x 100 bases at the session's match capacity): probe_bloom's
   survivors, keys and count exactly, cuckoo_verify's match list sorted by
   (row, entry) with its counts, match_assemble's [8192, maxm] slots,
   rids, in_u and overflow exactly on that list, case_count's counts,
   pairs and rcount exactly on the batch's [8192, maxm] slots in quant and
   sc mode; first_of_run (a build kernel since match_assemble took its
   query use) at n = 2^20; median CUDA-event times of both beside the
   kernel's bound, and the kernel's device-only time (case_count's and
   match_assemble's launch geometry on lines of their own: lanes a read,
   reads a block, blocks, registers, resident blocks an SM); then the
   upload at 2 bits a base: the main path's first batch ([8192, 100]) and
   the benchmark's (its first 65,536 reads) packed by the native packer
   into a pinned buffer (byte-equal to pack_reads_plain) and unpack_reads
   on the card against unpack_reads_plain on the same device buffer and
   against the batch, exactly, beside its bound; then probe_bloom's two
   levels: a sweep of random 4-byte gathers (torch.index_select, 4,915,200
   a call, the pass's probe rows) into tables of 4-64 MB, printed as
   gathers a ns, to show where the L2 stops holding a table that every SM
   reads; and probe_bloom at the benchmark's batch (65,536 x 100) against
   the config-#3 filter with one level (the level-1 fold taken off the
   device index) and with two (the index as the session made it: it must
   have a level 1), each against its plain version, device only, beside
   its bound and the share of the rows sent to level 2;
4. toy end to end through the CLI (5 x 2000 bp genomes, 4000 simulated
   reads, index built on cuda): quant abundances within 0.01 of the truth
   for all 5 genomes, a Type-I file identical to the one the CPU path
   writes;
5. main path at config-#3 scale: QuerySession.from_artifact on cuda over 16
   batches of 8192 reads, then build_problem + solve_quant; the kernels'
   launch counters are zeroed just before and read just after, and every
   kernel must have launched, unpack_reads (the session's upload) too; a
   second pass must give the first's counts; one batch must give identical
   counts through the kernels (cuda) and the plain versions (cpu), and one
   batch, in quant and in sc mode, must run under
   torch.cuda.set_sync_debug_mode("error") (no host sync); the host syncs
   of a whole pass of each mode are counted in "warn" mode and printed.
   Peak device memory is printed;
6. Type-II at config-#3 scale: the same reads in sc mode (launch counters
   zeroed before, read after); cnts_u/cnts_d/nundet/nconf must equal the
   quant pass, a second sc pass its pair counts, the pair counts go to
   solve_ident, and one batch's outputs, pair outputs included, must be
   identical through the kernels (cuda) and the plain versions (cpu);
8. distributed query (parallel/): (a) a world of one rank over NCCL
   (TCPStore on 127.0.0.1) and its 1 x 1 ProcessGrid;
   QuerySession.from_artifact(grid=...) builds its shard (the whole index)
   and must give the single session's quant and sc counts, make no host
   sync in a quant or sc batch (sync debug mode "error") and one in a pass;
   (b) two model shards of the config-#3 artifact on the one card (their
   build timed, their geometry printed), the 16 batches probed through the
   kernels against both, the slots concatenated as a row's all_gather
   gives them, then case_count (counts and rcount): counts equal the
   unsharded session's; each query kernel at the shard's shapes against
   its plain version, timed beside its whole-index time, and case_count
   at the concatenated [8192, 2 x maxm] (launch counters zeroed before
   (a)'s pass and (b)'s batches, read after);
9. the gather engine at config-#3 scale (query/classify.py, kernel
   gather_probe): QuerySession(engine="gather") on cuda from the npz pair
   phase 2 saved (the time of the unique table's probe-run check at
   staging printed), the same 16 batches in quant and sc mode (launch counters
   zeroed before the quant pass, read after); its counts, rcounts and pair
   counts must equal the sort-join session's (phases 5, 6); one batch in
   each mode under sync debug mode "error" and one sync a pass; the kernel
   against its plain version on the same CUDA tensors at one batch's
   shapes, beside its bound and the mean table rows a probe walks in each
   table (to its hit or its first empty row), and case_count against its
   plain version on the batch's [8192, 300] slots;
10. toy Type-II through the CLI: 5 genomes x 2000 bp with a 300 bp segment
   planted in each pair of neighbours, indexed by `--build --device cuda`
   and by `--build --device cpu` (files must be equal), then a Type-II file
   from `--device cuda` identical to the one from `--device cpu`, with
   nonzero pair counts;
11. the device build on cuda against the same build on the CPU device (the
   plain versions of every kernel), array for array, on the bench generator
   at BUILD_CHECK_GENOMES genomes (chosen so the CPU build takes about two
   minutes); stage seconds of both are printed;
12. build kernels against their plain versions on the config-#3 build's own
   tensors (recomputed from the corpus): first_of_run at the build's n in
   full, in index and value mode, forward and reverse; segmented_min at
   the build's n in full on its lcp and run starts (forward) and ends
   (reverse, on lcp[1:n+1]), as the LCP0 stages call it; lcp_pairs and
   occ_count (unique and doubly) timed at full n (lcp_pairs also with
   clamp 32, its thread phase alone), and, with their plain
   versions, on a contiguous slice of 2^24 ranks around the longest LCP
   (the plain versions loop in Python over live sets, too slow for 6e8
   ranks within the time limit); exact equality required;
13. the host build engines (index/builder.py engine="native", parallel/
   dist_build.py) against phase 11's cuda build, on the host's CPU cores
   (model and os.cpu_count() printed): (a) the native bounded sort and
   (b) SA-IS (bounded_sa=False) at BUILD_CHECK_GENOMES genomes, (c) the
   cross-host build of 2 slices in worker processes at DIST_GENOMES
   genomes against the cuda build with num_groups=2; each index, its ulm
   counts and meta files identical, the first_of_run, segmented_min,
   lcp_pairs and occ_count launches of phase 11's cuda build required;
   stage seconds beside the cuda build's and the cross-host build's peak
   RSS per worker printed (run after phase 11, before phase 12);
14. index formats on the card (last): (a) the bench generator at
   DIST_GENOMES genomes built on cuda (k=26 L=100 Lmax=50 h=26), both
   tables written in the reference's .bin1/.bin2 format and read back
   (index/refcompat.py; seconds of the host's bit loop printed), entry
   sets equal; QuerySession on cuda from the imported and the original
   pair, both engines, REF_BATCHES batches in quant and sc mode: counts,
   pair counts and rcounts by entry key equal, every query kernel
   launched (counters zeroed before, read after), one batch through the
   plain versions (cpu) equal; (b) phase 10's toy with pairs through the
   format: its Type-II pair counts and file on cuda equal the original's;
   (c) a copy of phase 2's artifact without its cuckoo table (arrays
   symlinked, meta.json with cuckoo_log 0): session start, ensure_cuckoo
   (True, then False; the table equal to phase 2's), session start again,
   each session's quant pass equal to phase 5's counts; (d) the command
   python -m cammiq_tpu_torch.index.artifact on phase 2's npz pair, every
   file equal to phase 2's artifact (a child process started before phase
   12, whose device work its host work overlaps, and waited for before (c)
   so that (c)'s times have the host to themselves);
15. quant at scale (after phase 9, on phase 2's artifact and session):
   benchmarks/realized_free.py's mixture (tools/benchdata.py:
   sample_mixture: MIX_PRESENT genomes in lognormal abundance,
   MIX_BATCHES batches of BATCH reads) through the session (set-up), its
   quant problems under the default, the stress and the constrained fine
   parameters (MIX_FINE; candidates, free candidates, C2 rows, n and terms
   printed), and solve_quant on the card for the stress and the
   constrained problem: every chunk one launch of quant_fista (counters
   zeroed before the two solves, read after), stage-1 chunks, enumeration
   rounds, B&B nodes, stopped_by, seconds by stage and the host bound's
   seconds a node printed; quant_fista against its plain version on the
   card on chunks captured from the stress solve (its first stage-1
   chunk, its first enumeration batch, its last B&B node's chunk) within
   QUANT_CHUNK_TOL, beside its bound; each whole solve against the plain
   version's (the same EXIST set, abundances within 1e-3 L1, the same
   stopped_by), the stress one only when the plain solve is estimated to
   end within MIX_PLAIN_LIMIT_S, else at the chunk level only.

Every kernel time is printed beside its bound and its device-only time
(device_ms: CUDA events around calls queued behind a sleep kernel, so
they run back to back on the device without the host's launch cost).
Whole passes are not timed: perfbench/run.py's cells measure them.  The bound is the least time the card could take
for the call, the larger of its bytes (each input read once,
each output written once, counting what this call's data needs) over
HBM_BYTES_PER_S and its operations over SCALAR_OPS_PER_S.

Before the last line it prints the nvidia-smi line and one JSON object
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Numbers and logs also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
BATCH = 8192
N_BATCHES = 16
SCAN_N = 1 << 20
TOY_TOL = 0.01
# the benchmark's batch of reads (perfbench's query cells)
BENCH_BATCH = 65536
# the gather sweep: table sizes (MB) and gathers a call (the benchmark's
# batch of 65,536 100-base reads at h = 26: 75 probe rows a read)
SWEEP_MB = (4, 8, 12, 16, 24, 32, 48, 64)
SWEEP_GATHERS = BENCH_BATCH * 75
BUILD_CHECK_GENOMES = 64
DIST_GENOMES = 8
SLICE = 1 << 24
DEV = "cuda"
# what torch's sync debug mode "warn" says at each host sync (its notice
# about the mode itself says "synchronizing" too)
SYNC_WARNING = "called a synchronizing CUDA operation"
# H100 SXM datasheet peaks: HBM3 bandwidth, and the
# float32 rate outside the tensor cores, taken as the peak of the scalar
# integer work these kernels do (the larger rate gives the smaller bound)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# name -> (source, what it replaces, the path whose launches it reports[,
# the comparison whose numbers it reports, when not its own name])
KERNEL_INFO = {
    # since match_assemble took its query use, a build kernel: its numbers
    # are phase 12's at the build's n, forward index mode (run_info's starts)
    "first_of_run": ("cammiq_tpu_torch/csrc/first_of_run.cu",
                     "benchmarks/pallas_repro.py:79", "build",
                     "first_of_run@build_n index rb"),
    "probe_bloom": ("cammiq_tpu_torch/csrc/probe_bloom.cu",
                    "cammiq_tpu/query/sortjoin.py:867", "quant"),
    "cuckoo_verify": ("cammiq_tpu_torch/csrc/cuckoo_verify.cu",
                      "cammiq_tpu/query/sortjoin.py:1142", "quant"),
    # XLA work, not a Pallas kernel: the match assembly's sort, rank and
    # scatters, at the whole index's batch and at one of two shards' (8b)
    "match_assemble": ("cammiq_tpu_torch/csrc/match_assemble.cu",
                       "cammiq_tpu/query/sortjoin.py:1268", "quant"),
    "match_assemble@shard": ("cammiq_tpu_torch/csrc/match_assemble.cu",
                             "cammiq_tpu/query/sortjoin.py:1268", "shards"),
    "lcp_pairs": ("cammiq_tpu_torch/csrc/lcp_pairs.cu",
                  "cammiq_tpu/ops/lcp.py:90", "build"),
    "occ_count": ("cammiq_tpu_torch/csrc/occ_count.cu",
                  "cammiq_tpu/index/unique_jax.py:132", "build"),
    # XLA work, not a Pallas kernel: the LCP0 stages' segmented minima,
    # forward (on lcp[:n] and the run starts) and reverse (lcp[1:n+1], ends)
    "segmented_min": ("cammiq_tpu_torch/csrc/segmented_min.cu",
                      "cammiq_tpu/ops/scans_jax.py:16", "build"),
    "segmented_min@rev": ("cammiq_tpu_torch/csrc/segmented_min.cu",
                          "cammiq_tpu/ops/scans_jax.py:36", "build"),
    "gather_probe": ("cammiq_tpu_torch/csrc/gather_probe.cu",
                     "cammiq_tpu/query/probe.py:129", "gather"),
    # XLA-fused work, not a Pallas kernel: case_analysis + rcounts_from_case,
    # at the sort join's slots and at the gather engine's
    "case_count": ("cammiq_tpu_torch/csrc/case_count.cu",
                   "cammiq_tpu/query/classify.py:160", "quant"),
    "case_count@gather": ("cammiq_tpu_torch/csrc/case_count.cu",
                          "cammiq_tpu/query/classify.py:160", "gather"),
    # the grid's width: two shards' slots concatenated, [8192, 2 x maxm]
    # (phase 8b)
    "case_count@shards": ("cammiq_tpu_torch/csrc/case_count.cu",
                          "cammiq_tpu/query/classify.py:160", "shards"),
    # XLA work, not a Pallas kernel: the quant solver's FISTA chunk
    # (fori_loop in fista, vmap over subsets in solve_subsets), at the
    # mixture's stage-1 chunk (S = 1), an enumeration batch (S = 2^m) and a
    # B&B node's chunk (phase 15)
    "quant_fista": ("cammiq_tpu_torch/csrc/quant_fista.cu",
                    "cammiq_tpu/models/quant.py:412", "quant_scale"),
    "quant_fista@enum": ("cammiq_tpu_torch/csrc/quant_fista.cu",
                         "cammiq_tpu/models/quant.py:523", "quant_scale"),
    "quant_fista@bnb": ("cammiq_tpu_torch/csrc/quant_fista.cu",
                        "cammiq_tpu/models/quant.py:412", "quant_scale"),
    # no TPU kernel: the JAX session hands XLA its int8 batch as it is; the
    # upload at 2 bits a base, at the main path's batch and the benchmark's
    "unpack_reads": ("cammiq_tpu_torch/csrc/read_pack.cu",
                     "cammiq_tpu/query/pipeline.py:362", "quant"),
    f"unpack_reads@{BENCH_BATCH}": ("cammiq_tpu_torch/csrc/read_pack.cu",
                                    "cammiq_tpu/query/pipeline.py:362", "quant"),
}
# the kernels each driven path must launch
SORTJOIN_KERNELS = ("probe_bloom", "cuckoo_verify", "match_assemble", "case_count")
GATHER_KERNELS = ("gather_probe", "case_count")
# a QuerySession's pass on the card uploads each batch through unpack_reads;
# the phases that call the kernels on device tensors of their own do not
UPLOAD_KERNELS = ("unpack_reads",)
PATH_KERNELS = {
    "quant": SORTJOIN_KERNELS + UPLOAD_KERNELS,
    "typeII": SORTJOIN_KERNELS + UPLOAD_KERNELS,
    "grid": SORTJOIN_KERNELS + UPLOAD_KERNELS,
    "shards": SORTJOIN_KERNELS,
    "build": ("first_of_run", "segmented_min", "lcp_pairs", "occ_count"),
    "build_check": ("first_of_run", "segmented_min", "lcp_pairs", "occ_count"),
    "gather": GATHER_KERNELS + UPLOAD_KERNELS,
    "refcompat": SORTJOIN_KERNELS + ("gather_probe",) + UPLOAD_KERNELS,
    "quant_scale": ("quant_fista",),
}
# phase 15: benchmarks/realized_free.py's mixture on the config-#3 index,
# and the fine parameters of its problems: the default, realized_free's
# stress variant (no EXP rows, every candidate free) and a constrained one
# (the default easy_to_identify_thres: C2 rows)
MIX_PRESENT = 60
MIX_BATCHES = 12
MIX_FINE = {"default": {},
            "stress": dict(read_cnt_thres=1, easy_to_identify_thres=10**9,
                           ilp_alpha=1e-9),
            "constrained": dict(read_cnt_thres=1, ilp_alpha=1e-9)}
MIX_STRESS_FREE = 9           # more than enum_cap: the B&B runs
MIX_PLAIN_LIMIT_S = 240       # the plain stress solve runs when it ends within
# a chunk's x, kernel against plain version: max |x - x_plain| within
# QUANT_CHUNK_TOL x max(1, max |x_plain|) (float32 sums in another order
# can move the projection's first feasible grid point by one step, which
# FISTA's momentum carries through the chunk; the plain version, its start
# moved by one ulp, moves as far)
QUANT_CHUNK_TOL = 1e-3
# phase 14: read batches on the reference-format index, and the engines
REF_BATCHES = 4
ENGINES = ("sortjoin", "gather")
INDEX_FIELDS = ("key_words", "length", "rid1", "rid2", "ucount1", "ucount2",
                "table_lo", "table_hi", "table_start", "table_count")
INDEX_STATICS = ("h", "kw", "max_probes", "max_bucket", "is_doubly")
META_FILES = ("genome_lengths.out", "unique_lmer_count_u.out",
              "unique_lmer_count_d.out")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "n/a"


def cuda_median_ms(fn, reps: int = 11, inner: int = 20, warmup: int = 3) -> float:
    """Median over `reps` of the CUDA-event time of `inner` back-to-back
    calls, divided by `inner`: ms per call as the path pays it, host
    launch cost included where it exceeds the device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return statistics.median(times)


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


def probe_canon(out, args):
    """probe_bloom's survivors, keys and count (entries past n are not
    part of the result)."""
    rows, keys, n = out
    k = int(n[0])
    return rows[:k], keys[:k], n


def match_canon(out, args):
    """cuckoo_verify's written matches as int64 row << 32 | entry, sorted
    (their order is not part of the result), and its counts."""
    import torch

    mrow, me, counts = out
    m = min(int(counts[0]), args[-1])
    return torch.sort((mrow[:m].long() << 32) | me[:m].long()).values, counts


# ---- bounds: the least time the card could take for one call

def bound(nbytes: float, ops: float = 0.0) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(ops)}


def bound_first_of_run(is_start, *values) -> dict:
    """1 flag byte per element; each value array read and its output
    written, or in index mode the int32 index written."""
    n, nv = is_start.numel(), len(values)
    return bound(n + (8 * nv if nv else 4) * n)


def bound_match_assemble(mrow, me, counts, prec, O, B, maxm, eu) -> dict:
    """8 bytes a valid match (row and entry) and the 32-byte prec sectors
    the valid matches touch, read once; the count; 13 bytes a slot written
    ([B, maxm] slots, rid1, rid2, in_u) and the overflow count."""
    import torch

    n = min(int(counts[0]), mrow.shape[0])
    at = me[:n].long() * 12
    sectors = torch.unique(torch.cat([at // 32, (at + 11) // 32])).numel()
    return bound(8 * n + 32 * sectors + 4 + 13 * B * maxm + 4)


def bound_unpack_reads(B: int, Lp: int) -> dict:
    """The packed batch read once; the int8 codes and int32 lengths
    written."""
    from cammiq_tpu_torch.kernels.read_pack import layout

    return bound(layout(B, Lp)[2] + B * Lp + 4 * B)


def bound_segmented_min(v, flags) -> dict:
    """4 bytes of value and 1 of flag read, 4 bytes written an element."""
    return bound(9 * v.numel())


def bound_probe_bloom(codes, bloom, h, blog, l1, l1_log, counts, n) -> dict:
    """The codes, the level-1 words this batch touches and the bloom words
    its rows sent to level 2 touch (every row's without a level 1), 8 bytes
    a survivor (row and key) and the count."""
    import torch

    from cammiq_tpu_torch import u32
    from cammiq_tpu_torch.kernels.probe_bloom import bloom_bits, probe_keys_plain

    key = probe_keys_plain(codes, h)
    words = 0
    if l1 is not None:
        need = bloom_bits(key)
        w1 = key >> (32 - l1_log)
        words = torch.unique(w1).numel()
        key = key[(u32.widen(l1)[w1] & need) == need]
    words += torch.unique(key >> (32 - blog)).numel()
    return bound(codes.numel() + 4 * words + 8 * int(n[0]) + 4)


def bound_cuckoo_verify(args, out) -> dict:
    """The survivors (row and key) and their count, the codes and lengths
    of the reads they fall in, the cuckoo rows they hash to, the entries
    they match (a lower bound: the bucket scan reads every entry of the
    span), 8 bytes a match written and the two counts."""
    import torch

    from cammiq_tpu_torch import u32
    from cammiq_tpu_torch.kernels.cuckoo_verify import cuckoo_pos

    rows, keys, n, codes, lengths, cuckoo, clog, erec, _, kp = args
    mrow, me, counts = out
    K = int(n[0])
    M = min(int(counts[0]), kp)
    O = rows.shape[0] // codes.shape[0]
    reads = torch.unique(rows[:K] // O).numel()
    key = u32.widen(keys[:K])
    crows = torch.unique(torch.cat([cuckoo_pos(key, 0, clog),
                                    cuckoo_pos(key, 1, clog)])).numel()
    ents = torch.unique(me[:M]).numel()
    return bound(8 * K + 4 + reads * (codes.shape[1] + 4)
                 + crows * cuckoo.shape[1] * 4 + ents * erec.shape[1] * 4
                 + 8 * M + 8)


def bound_gather_probe(du, dd, codes, lengths, out) -> dict:
    """Bytes: the codes and lengths, each 16-byte table row the probes walk
    (to a probe's hit or its first empty row, that row included, at most
    max_probes rows), each entry record the bucket scans read (to the
    match, or the whole scan; kw + 3 words), and 13 bytes a slot written,
    each row and record counted once.  Operations: ~40 a slot (windows,
    hash), 6 a row walked, 4 kw + 6 an entry scanned.  Also the mean rows
    walked per probe of each table."""
    import torch

    from cammiq_tpu_torch import u32
    from cammiq_tpu_torch.kernels.gather_probe import BIG
    from cammiq_tpu_torch.query import probe as tp

    slots = out[0]
    B, Lp = codes.shape
    O = slots.shape[1] // 4
    dev = codes.device
    m0, m1 = tp._prefix_masks(du.h)
    p16s = [torch.cat([tp.pack_rolling16(x),
                       torch.zeros(B, O + 16, dtype=torch.int64, device=dev)], 1)
            for x in (codes, tp.revcomp_batch(codes, lengths))]
    nbytes = codes.numel() + 4 * B + 13 * slots.numel()
    ops = 40 * slots.numel()
    rows_walked = {}
    for t, (name, didx, base) in enumerate((("unique", du, 0),
                                            ("doubly", dd, du.length.shape[0]))):
        tmask = (1 << didx.table_bits) - 1
        P, MB = didx.max_probes, didx.max_bucket
        rows, ents, walked_all = [], [], []
        for s, p16 in enumerate(p16s):
            lo = p16[:, :O] & m0
            hi = (p16[:, 16:16 + O] & m1) if du.h > 16 else torch.zeros_like(lo)
            slot0 = tp.hash_prefix(lo, hi) & tmask
            bstart = torch.full_like(lo, -1)
            bcount = torch.zeros_like(lo)
            walked = torch.full_like(lo, P)
            alive = torch.ones_like(lo, dtype=torch.bool)
            for p in range(P):
                slot = (slot0 + p) & tmask
                start = didx.table_start[slot]
                hit = ((u32.widen(didx.table_lo[slot]) == lo)
                       & (u32.widen(didx.table_hi[slot]) == hi) & (start >= 0))
                stop = alive & (hit | (start < 0))
                bstart = torch.where(stop & hit, start.long(), bstart)
                bcount = torch.where(stop & hit, didx.table_count[slot].long(), bcount)
                walked = torch.where(stop, p + 1, walked)
                alive &= ~stop
            col = slots[:, (2 * t + s) * O:(2 * t + s + 1) * O].long()
            scanned = torch.where(col < BIG, col - base - bstart + 1,
                                  bcount.clamp(max=MB))
            scanned = torch.where(bstart >= 0, scanned, 0)
            ar = torch.arange(P, device=dev)
            rows.append(((slot0[..., None] + ar) & tmask)[ar < walked[..., None]])
            ar = torch.arange(MB, device=dev)
            ents.append((bstart[..., None] + ar)[ar < scanned[..., None]])
            walked_all.append(walked)
            ops += 6 * int(walked.sum()) + (4 * didx.kw + 6) * int(scanned.sum())
        rows_walked[name] = float(torch.cat(walked_all).double().mean())
        nbytes += 16 * torch.unique(torch.cat(rows)).numel()
        nbytes += 4 * (didx.kw + 3) * torch.unique(torch.cat(ents)).numel()
        del rows, ents
    return {**bound(nbytes, ops), "rows_walked_mean": rows_walked}


def bound_lcp_pairs(text, sa, lcp) -> dict:
    """Bytes: sa and out once, and the text bytes the pairs need (the union
    over ranks of each suffix's longer comparison plus the byte that
    differs); operations: one 32-bit compare per 4 bytes compared."""
    import torch

    n, m = text.numel(), sa.numel()
    if m == n:          # a whole suffix array: every byte starts a suffix
        text_bytes = n
    else:
        a = sa.long()
        need = torch.minimum(torch.maximum(lcp[:m], lcp[1:m + 1]).long() + 1, n - a)
        a, order = torch.sort(a)
        e = a + need[order]
        del need, order
        reach = torch.cummax(e, 0).values
        prev = torch.cat([a[:1], reach[:-1]])
        text_bytes = int((e - torch.maximum(a, prev)).clamp_(min=0).sum())
    ops = int(((lcp[1:m].long() + 4) // 4).sum())
    return bound(text_bytes + 8 * m + 4, ops)


def bound_occ_unique(lcp, lcp0, gsa) -> dict:
    n = gsa.numel()
    return bound(4 * (n + 1) + 12 * n)


def bound_occ_doubly(lcp, lcp0, gsa, g2, ulmax, end_excl) -> dict:
    """lcp0 of every rank and both outputs; lcp, gsa and g2 of the ranks
    that walk (lcp0 <= ulmax past end_excl)."""
    import torch

    n = gsa.numel()
    walk = int(((lcp0 <= ulmax) & (torch.arange(n, device=gsa.device) > end_excl)).sum())
    return bound(12 * n + 12 * walk)


def bound_quant_fista(p, S, n_it, stats) -> dict:
    """x0, lb, ub [S, n], lam [S, C2], tg, c2_rhs and the folded terms read
    once, x [S, n] and the stats written once; the float operations of
    the iterations: the gradient's 2 nnz(H) (and 2 nnz(R) + 2 nnz(M) + 4
    C2 with C2 rows) and about 30 a coordinate a iteration, and, in each
    projection that ran the grid (counted by the kernel), 3 rounds x 256
    points x (4 a coordinate with lb < ub + 2) and 3 a coordinate."""
    f = p.folded
    n, C2 = p.n, p.C2
    nbytes = (4 * (4 * S * n + S * C2 + n + C2) + 8 * S
              + sum(t.numel() * t.element_size() for t in f.values()))
    per_it = 2 * f["h_val"].numel() + 30 * n
    if p.has_c2:
        per_it += 2 * f["r_val"].numel() + 2 * f["m_val"].numel() + 4 * C2
    grids, nf = stats[:, 0].long().cpu(), stats[:, 1].long().cpu()
    grid_ops = int((grids * (3 * 256 * (4 * nf + 2) + 3 * n)).sum())
    return bound(nbytes, S * n_it * per_it + grid_ops)


def kernel_counters() -> dict:
    from cammiq_tpu_torch.kernels import (case_count, cuckoo_verify,
                                          first_of_run, gather_probe, lcp_pairs,
                                          match_assemble, occ_count, probe_bloom,
                                          quant_fista, read_pack, segmented_min)

    return {"first_of_run": first_of_run.KERNEL,
            "probe_bloom": probe_bloom.KERNEL,
            "cuckoo_verify": cuckoo_verify.KERNEL,
            "match_assemble": match_assemble.KERNEL,
            "segmented_min": segmented_min.KERNEL,
            "lcp_pairs": lcp_pairs.KERNEL, "occ_count": occ_count.KERNEL,
            "gather_probe": gather_probe.KERNEL,
            "case_count": case_count.KERNEL,
            "quant_fista": quant_fista.KERNEL,
            "unpack_reads": read_pack.KERNEL}


def zero_counts() -> None:
    for k in kernel_counters().values():
        k.launches = 0


def read_counts(path: str, results: dict) -> dict:
    """Launch counts since zero_counts(); raises unless every kernel of
    `path` launched."""
    got = {name: k.launches for name, k in kernel_counters().items()}
    results.setdefault("launches", {})[path] = got
    missing = [k for k in PATH_KERNELS[path] if not got[k]]
    if missing:
        raise AssertionError(f"{path}: kernels not launched {missing}: {got}")
    return got


def capture_kernel_calls(fn) -> dict:
    """Run ``fn`` (one query batch) with each query kernel's wrapper in
    query/sortjoin.py recording its positional arguments and result: name
    -> (args, out) of its last call."""
    import cammiq_tpu_torch.query.sortjoin as sj

    captured, originals = {}, {}
    for name in ("probe_bloom", "cuckoo_verify", "match_assemble", "case_count"):
        orig = getattr(sj, name)
        originals[name] = orig

        def rec(*a, _n=name, _f=orig, **kw):
            out = _f(*a, **kw)
            captured[_n] = (a, out)
            return out

        setattr(sj, name, rec)
    try:
        fn()
    finally:
        for name, orig in originals.items():
            setattr(sj, name, orig)
    return captured


def count_syncs(fn) -> int:
    """Host syncs while ``fn`` runs, counted in sync debug mode "warn"."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def max_abs_err(a, b) -> float:
    if a.shape != b.shape:
        return float("inf")
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max()) if a.numel() else 0


def assert_same_index(got, want, what: str) -> None:
    """Every array and static of two FlatIndex tables."""
    import numpy as np

    for f in INDEX_FIELDS:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{what}: {f} differs")
    for f in INDEX_STATICS:
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{what}: {f} differs")


def assert_same_artifacts(got, want, what: str) -> None:
    """Both tables, the ulm counts, the genome lengths and the meta files of
    two builds."""
    import numpy as np

    from cammiq_tpu_torch.index.builder import write_meta_outputs

    for name in ("unique_index", "doubly_index"):
        assert_same_index(getattr(got, name), getattr(want, name), f"{what} {name}")
    for f in ("ulm_count_u", "ulm_count_d", "genome_lengths"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{what}: {f} differs")
    tmp = tempfile.mkdtemp(prefix="smoke_meta_", dir=OUT_DIR)
    try:
        for tag, art in (("got", got), ("want", want)):
            write_meta_outputs(art, os.path.join(tmp, tag))
        for f in META_FILES:
            with open(os.path.join(tmp, "got", f)) as a, \
                    open(os.path.join(tmp, "want", f)) as b:
                if a.read() != b.read():
                    raise AssertionError(f"{what}: {f} differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sample_reads(genomes, batches: int, seed: int):
    """A ReadSet of ``batches`` batches of BATCH reads from the bench
    generator's read sampler."""
    import numpy as np

    from cammiq_tpu_torch.io.fastq import ReadSet
    from cammiq_tpu_torch.tools.benchdata import sample_read_batch

    rng = np.random.default_rng(seed)
    parts = [sample_read_batch(rng, genomes, BATCH) for _ in range(batches)]
    codes = np.concatenate([p[0] for p in parts])
    lengths = np.concatenate([p[1] for p in parts])
    return ReadSet(codes=codes, lengths=lengths, total_len=int(lengths.sum()),
                   name="bench")


def entry_rows(ix, values=None):
    """A table's entries as sorted int64 rows (key words, length, then
    rid1, rid2, ucount1, ucount2, or ``values`` by entry id): equal for
    two tables that hold the same entries in any order."""
    import numpy as np

    cols = [np.asarray(ix.key_words, np.int64), np.asarray(ix.length, np.int64)[:, None]]
    cols += [np.asarray(c, np.int64)[:, None] for c in
             ((ix.rid1, ix.rid2, ix.ucount1, ix.ucount2) if values is None else (values,))]
    rows = np.concatenate(cols, 1)
    return rows[np.lexsort(rows.T[::-1])]


def cpu_model() -> str:
    """The host CPU's model name (/proc/cpuinfo, else lscpu), and the
    machine's architecture."""
    import platform

    name = ""
    try:
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name")), "")
    except OSError:
        pass
    if not name:
        try:
            r = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30)
            name = next((ln.split(":", 1)[1].strip() for ln in r.stdout.splitlines()
                         if ln.strip().startswith("Model name")), "")
        except (OSError, subprocess.TimeoutExpired):
            pass
    return f"{name or 'model not reported'} ({platform.machine()})"


def stage_table(stages: dict, peaks: dict, other: dict | None = None,
                other_name: str = "cpu") -> str:
    return "\n".join(
        f"  {k:<48} {v:9.3f} s" + (f"   {other_name} {other.get(k, float('nan')):9.3f} s"
                                   if other is not None else "")
        + (f"   peak {peaks[k] / 1e9:6.2f} GB" if k in peaks else "")
        for k, v in stages.items())


class Tee(io.StringIO):
    """A text buffer that also writes through to another stream."""

    def __init__(self, other):
        super().__init__()
        self.other = other

    def write(self, s):
        self.other.write(s)
        return super().write(s)


class Smoke:
    def __init__(self):
        self.failed = []
        self.results = {}
        self.kernels = {}
        self.quant_counts = None
        self.toy_pairs = None
        self.artifact_cmd = None

    def phase(self, name, fn, *args):
        log(f"== {name}")
        t = time.time()
        try:
            out = fn(*args)
            log(f"== {name}: ok ({time.time() - t:.1f} s)")
            return out
        except Exception:
            traceback.print_exc(file=sys.stdout)
            log(f"== {name}: FAILED ({time.time() - t:.1f} s)")
            self.failed.append(name)
            return None

    def compare(self, name, kern, plain, args, bnd, reps=(11, 20, 3),
                plain_reps=(11, 20, 3), canon=None, **kw):
        """Kernel against its plain version on the same CUDA tensors: equal
        results (``canon`` maps an output to what must be equal), median
        CUDA-event times, the device-only time, the bound beside them."""
        import torch

        got = kern(*args, **kw)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        want = plain(*args, **kw)
        e.record()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if canon is not None:
            got, want = canon(got, args), canon(want, args)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        same = all(g.shape == w.shape and torch.equal(g, w)
                   for g, w in zip(got, want))
        ms = cuda_median_ms(lambda: kern(*args, **kw), *reps)
        dev_ms = device_ms(lambda: kern(*args, **kw), max(reps[1], 5))
        # one timed call, no warm-up: the checking call above is that call
        plain_ms = (s.elapsed_time(e) if tuple(plain_reps) == (1, 1, 0) else
                    cuda_median_ms(lambda: plain(*args, **kw), *plain_reps))
        shape = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        dev = (f"{dev_ms:.4f} ms, {100 * bnd['bound_ms'] / dev_ms:.1f}% of bound"
               if dev_ms else "not measured: the host outran the sleep")
        log(f"{name}: shapes {shape} equal={same} max_abs_err={err} kernel "
            f"{ms:.4f} ms (device only {dev}) plain {plain_ms:.4f} ms "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}: {bnd['bytes']} B, "
            f"{bnd['ops']} ops) -> {100 * bnd['bound_ms'] / ms:.1f}% of bound")
        self.kernels[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                              "plain_ms": plain_ms, "shapes": shape, **bnd}
        if not same:
            raise AssertionError(f"{name}: kernel != plain version")
        return got

    def case_count_vs_plain(self, name, ms, lengths, G, E):
        """case_count against its plain version on the same CUDA tensors,
        in quant and sc mode: counts, pairs and the rcount into a fresh
        [E] target exactly; then both timed (an rcount target kept across
        calls) beside the bound of ``case_count_traffic``."""
        import torch

        from cammiq_tpu_torch.kernels import case_count as kcc

        err = 0
        for sc in (False, True):
            outs = []
            for fn in (kcc.case_count, kcc.case_count_plain):
                rc = torch.zeros(E, dtype=torch.int32, device=lengths.device)
                outs.append((*fn(ms, lengths, G, sc_mode=sc, rcount=rc), rc))
            torch.cuda.synchronize()
            err = max(err, *(max_abs_err(a, b) for a, b in zip(*outs)))
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"{name}: kernel != plain version (sc_mode={sc})")
        rc = torch.zeros(E, dtype=torch.int32, device=lengths.device)
        traffic = kcc.case_count_traffic(ms, lengths, G, rc)
        log(f"{name}: slots {tuple(ms.slots.shape)}, {traffic['valid']} valid in "
            f"{traffic['rid_sectors']} 32-byte sectors of each rid array, "
            f"{traffic['rcount_touched']} rcount elements touched; counts, "
            f"pairs and rcount equal the plain version's in quant and sc mode")
        geometry = kcc.case_count_geometry(ms.slots)
        log(f"{name} launch geometry: {geometry}")
        self.compare(name, kcc.case_count, kcc.case_count_plain, (ms, lengths, G),
                     bound(traffic["bytes"], traffic["ops"]), plain_reps=(5, 5, 1),
                     rcount=rc)
        self.kernels[name]["max_abs_err"] = max(err, self.kernels[name]["max_abs_err"])
        self.kernels[name]["geometry"] = geometry

    def match_assemble_vs_plain(self, name, args):
        """match_assemble against its plain version on the list a batch
        handed it (every output exactly), timed beside its bound, with its
        launch geometry."""
        import torch

        from cammiq_tpu_torch.kernels import match_assemble as kma

        mrow, _, counts, _, O, B, maxm, _ = args
        geometry = kma.match_assemble_geometry(mrow.shape[0], B, maxm, mrow.device)
        n = min(int(counts[0]), mrow.shape[0])
        held = torch.bincount(mrow[:n].long() // O, minlength=B)
        log(f"{name}: {n} valid matches of KP = {mrow.shape[0]} into [{B}, "
            f"{maxm}] (O = {O}), {int((held > 4 * geometry['lanes']).sum())} "
            f"reads past their bucket, at most {int(held.max())} a read; "
            f"launch geometry: {geometry}")
        self.compare(name, kma.match_assemble, kma.match_assemble_plain, args,
                     bound_match_assemble(*args))
        self.kernels[name]["geometry"] = geometry

    # ---- 1. header + kernel and native builds
    def header(self):
        import torch

        from cammiq_tpu_torch import native
        from cammiq_tpu_torch.kernels import build

        nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
        log(f"python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} nvcc: {nvcc}")
        t = time.time()
        build.load()
        self.results["kernel_build_s"] = time.time() - t
        log(f"kernel build: {self.results['kernel_build_s']:.1f} s "
            f"({build.library_path().name})")
        log(build.library_path().with_suffix(".log").read_text().strip())
        t = time.time()
        if not native.available():
            raise RuntimeError(f"native host library unavailable: {native.build_error()}")
        self.results["native_build_s"] = time.time() - t
        log(f"native host library: {self.results['native_build_s']:.1f} s "
            f"({native.library_path().name})")

    # ---- 2. config-#3 index, built by the port on the card (set-up)
    def realistic_index(self):
        import torch

        from cammiq_tpu_torch.config import BuildConfig
        from cammiq_tpu_torch.index.artifact import prepare_merged
        from cammiq_tpu_torch.index.builder import build_index, save_index
        from cammiq_tpu_torch.io.fasta import corpus_from_sequences
        from cammiq_tpu_torch.tools.benchdata import (BENCH_GENOMES, BENCH_GLEN,
                                                      gen_genomes)

        cdir = os.path.join(REPO, "bench_cache",
                            f"torch_g{BENCH_GENOMES}_l{BENCH_GLEN // 1000}k")
        shutil.rmtree(cdir, ignore_errors=True)
        t0 = time.time()
        corpus = corpus_from_sequences(gen_genomes(BENCH_GENOMES, BENCH_GLEN))
        gen_s = time.time() - t0
        cfg = BuildConfig(k=26, L=100, Lmax=50, h=26, mode="both")
        torch.cuda.empty_cache()
        zero_counts()
        # the build prints each stage's time and peak device memory
        err = Tee(sys.stderr)
        t = time.time()
        with contextlib.redirect_stderr(err):
            art = build_index(corpus, cfg, device=DEV, verbose=True)
        build_s = time.time() - t
        launches = read_counts("build", self.results)
        peaks = {m.group(1): int(m.group(2)) * 2**20 for m in re.finditer(
            r"Peak device memory for (.+?): (\d+) MiB\.", err.getvalue())}
        t = time.time()
        save_index(art, cdir)
        save_s = time.time() - t
        ne = (art.unique_index.num_entries, art.doubly_index.num_entries)
        del art
        t = time.time()
        mdir = os.path.join(cdir, "merged")
        prepare_merged(os.path.join(cdir, "index_u.npz"),
                       os.path.join(cdir, "index_d.npz"), mdir, verbose=True)
        merged_s = time.time() - t
        stages = dict(re.findall(r"Time for (.+?): (\d+) ms\.", err.getvalue()))
        stages = {k: int(v) / 1e3 for k, v in stages.items()}
        self.results.update(
            genomes=BENCH_GENOMES, genome_len=BENCH_GLEN,
            index_build_s=time.time() - t0,
            device_build={"n": corpus.n, "corpus_gen_s": gen_s, "build_s": build_s,
                          "stages_s": stages, "stage_peak_bytes": peaks,
                          "peak_device_bytes": max(peaks.values(), default=0),
                          "save_s": save_s, "prepare_merged_s": merged_s,
                          "entries": ne, "launches": launches})
        log(f"config-#3 device build of n={corpus.n} in {build_s:.1f} s (corpus "
            f"made in {gen_s:.1f} s), peak device memory "
            f"{max(peaks.values(), default=0) / 1e9:.2f} GB, entries {ne}, "
            f"launches {launches}; stages (device | peak):\n"
            + stage_table(stages, peaks)
            + f"\n  save {save_s:.1f} s, prepare_merged {merged_s:.1f} s; set-up "
            f"total {self.results['index_build_s']:.1f} s -> {mdir}")
        return mdir

    def reads(self):
        from cammiq_tpu_torch.tools.benchdata import (BENCH_GENOMES, BENCH_GLEN,
                                                      gen_genomes)

        return sample_reads(gen_genomes(BENCH_GENOMES, BENCH_GLEN), N_BATCHES, 1)

    def session(self, mdir):
        import torch

        from cammiq_tpu_torch.config import QueryConfig
        from cammiq_tpu_torch.index.artifact import load_merged_artifact
        from cammiq_tpu_torch.query.pipeline import QuerySession

        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        art = load_merged_artifact(mdir)
        sess = QuerySession.from_artifact(
            art, self.results["genomes"] + 1,
            QueryConfig(h=art.h, erate=0.01, batch_size=BATCH), device=DEV)
        torch.cuda.synchronize()
        self.results["session_start_s"] = time.time() - t
        self.results["index_entries"] = art.E
        self.results["bucket_rows"] = art.NB
        self.results["max_bucket"] = art.max_bucket
        self.results["n_colors"] = art.n_colors
        self.results["index_device_bytes"] = sum(
            t.numel() * t.element_size()
            for t in (sess.dm.bloom, sess.dm.bloom_l1, sess.dm.cuckoo,
                      sess.dm.erec, sess.dm.prec) if t is not None)
        log(f"session start {self.results['session_start_s']:.1f} s: E={art.E} "
            f"NB={art.NB} max_bucket={art.max_bucket} n_colors={art.n_colors} "
            f"device index {self.results['index_device_bytes'] / 1e9:.3f} GB")
        return art, sess

    # ---- 3. kernels vs plain versions at the main path's shapes
    def kernels_vs_plain(self, sess, reads):
        import numpy as np
        import torch

        import cammiq_tpu_torch.query.sortjoin as sj
        from cammiq_tpu_torch.kernels import cuckoo_verify as kcv
        from cammiq_tpu_torch.kernels import first_of_run as kfr
        from cammiq_tpu_torch.kernels import probe_bloom as kpb

        dev = sess.device
        codes = torch.from_numpy(reads.codes[:BATCH]).to(dev).contiguous()
        lengths = torch.from_numpy(reads.lengths[:BATCH]).to(dev)
        captured = capture_kernel_calls(
            lambda: sj.classify_batch(sess.dm, codes, lengths,
                                      sess.num_genome_slots, sess.maxm,
                                      frac=sess.frac))
        rng = np.random.default_rng(3)
        scan_big = (torch.from_numpy(rng.random(SCAN_N) < 0.05).to(dev),
                    torch.from_numpy(rng.integers(0, 1 << 30, SCAN_N)
                                     .astype(np.int32)).to(dev))
        pb_args, (_, _, n) = captured["probe_bloom"]
        cv_args, cv_out = captured["cuckoo_verify"]
        ma_args, _ = captured["match_assemble"]
        log(f"batch: {n.item()} survivors of {pb_args[0].shape[0]} x "
            f"{cv_args[0].shape[0] // pb_args[0].shape[0]} rows, "
            f"{cv_out[2].tolist()} matches (found, beyond KP = {cv_args[-1]})")
        self.compare("probe_bloom", kpb.probe_bloom, kpb.probe_bloom_plain,
                     pb_args, bound_probe_bloom(*pb_args, n), canon=probe_canon)
        self.compare("cuckoo_verify", kcv.cuckoo_verify, kcv.cuckoo_verify_plain,
                     cv_args, bound_cuckoo_verify(cv_args, cv_out),
                     canon=match_canon)
        self.match_assemble_vs_plain("match_assemble", ma_args)
        self.compare("first_of_run@2^20", kfr.first_of_run_scan,
                     kfr.first_of_run_scan_plain, scan_big,
                     bound_first_of_run(*scan_big))
        (ms, _, G), _ = captured["case_count"]
        self.case_count_vs_plain("case_count", ms, lengths, G,
                                 sess.dm.eu + sess.dm.ed)

    # ---- 3. probe_bloom's two levels at the benchmark's batch
    def gather_sweep(self):
        """Random 4-byte gathers (index_select, SWEEP_GATHERS a call) into
        tables of SWEEP_MB megabytes, device only, as gathers a ns."""
        import torch

        gen = torch.Generator(device=DEV).manual_seed(5)
        out = torch.empty(SWEEP_GATHERS, dtype=torch.int32, device=DEV)
        rates = {}
        for mb in SWEEP_MB:
            words = mb << 18
            table = torch.randint(-2**31, 2**31 - 1, (words,), dtype=torch.int32,
                                  device=DEV, generator=gen)
            idx = torch.randint(0, words, (SWEEP_GATHERS,), dtype=torch.int32,
                                device=DEV, generator=gen)
            ms = device_ms(lambda: torch.index_select(table, 0, idx, out=out))
            rates[mb] = SWEEP_GATHERS / (ms * 1e6) if ms else None
            del table, idx
        self.results["gather_sweep_per_ns"] = rates
        log(f"random 4-byte gathers a ns by table size ({SWEEP_GATHERS} a "
            f"call, device only): " + ", ".join(
                f"{mb} MB {r:.2f}" if r else f"{mb} MB not measured"
                for mb, r in rates.items()))

    def probe_levels(self, sess, reads):
        """probe_bloom at the benchmark's batch against the config-#3
        filter, one level and two, each against its plain version."""
        import dataclasses

        import torch

        from cammiq_tpu_torch.kernels import probe_bloom as kpb

        self.gather_sweep()
        dm = sess.dm
        if dm.bloom_l1 is None:
            raise AssertionError(f"the config-#3 index's bloom (2^{dm.bloom_log} "
                                 "words) has no level 1 on this card")
        codes = torch.from_numpy(reads.codes[:BENCH_BATCH]).to(DEV).contiguous()
        N = codes.shape[0] * kpb.num_offsets(codes.shape[1], dm.h)
        one = dataclasses.replace(dm, bloom_l1=None, bloom_l1_log=0)
        for name, d in ((f"probe_bloom@{BENCH_BATCH}", one),
                        (f"probe_bloom@{BENCH_BATCH} two levels", dm)):
            args = (codes, d.bloom, d.h, d.bloom_log, d.bloom_l1, d.bloom_l1_log)
            counts = torch.zeros(2, dtype=torch.int32, device=DEV)
            n = kpb.probe_bloom(*args, counts)[2]
            self.compare(name, kpb.probe_bloom, kpb.probe_bloom_plain, args,
                         bound_probe_bloom(*args, None, n), plain_reps=(1, 1, 0),
                         canon=probe_canon)
            level2, survivors = counts.tolist()
            self.kernels[name].update(rows=N, level2=level2, survivors=survivors)
            level1 = (f"level 1 2^{d.bloom_l1_log} words" if d.bloom_l1_log
                      else "no level 1")
            log(f"{name}: bloom 2^{d.bloom_log} words, {level1}, {N} rows, "
                f"{level2} sent to level 2 (share {level2 / N:.4f}), "
                f"{survivors} survivors")

    # ---- 3. the upload at 2 bits a base: the packer and unpack_reads
    def upload_vs_plain(self, reads):
        import numpy as np
        import torch

        from cammiq_tpu_torch.kernels import read_pack as krp

        for B in (BATCH, BENCH_BATCH):
            codes, lengths = reads.codes[:B], reads.lengths[:B]
            Lp = codes.shape[1]
            hb = torch.empty(krp.layout(B, Lp)[2], dtype=torch.uint8,
                             pin_memory=True)
            if not krp.pack_reads(codes, lengths, hb.numpy()):
                raise AssertionError(f"[{B}, {Lp}]: the batch did not pack")
            if not np.array_equal(hb.numpy(), krp.pack_reads_plain(codes, lengths)):
                raise AssertionError(f"[{B}, {Lp}]: packer != pack_reads_plain")
            name = "unpack_reads" if B == BATCH else f"unpack_reads@{B}"
            got = self.compare(name, krp.unpack_reads, krp.unpack_reads_plain,
                               (hb.to(DEV), B, Lp), bound_unpack_reads(B, Lp))
            if not (np.array_equal(got[0].cpu().numpy(), codes)
                    and np.array_equal(got[1].cpu().numpy(), lengths)):
                raise AssertionError(f"{name}: the codes or lengths differ "
                                     "from the batch")

    # ---- 4. toy end to end through the CLI
    def toy_cli(self):
        import numpy as np

        from cammiq_tpu_torch import cli
        from cammiq_tpu_torch.kernels import (case_count, cuckoo_verify,
                                              match_assemble, probe_bloom)
        from cammiq_tpu_torch.models.output import parse_quant_output
        from cammiq_tpu_torch.tools.simulate import simulate

        os.makedirs(OUT_DIR, exist_ok=True)
        root = tempfile.mkdtemp(prefix="smoke_toy_", dir=OUT_DIR)
        try:
            rng = np.random.default_rng(42)
            alpha = np.frombuffer(b"ACGT", np.uint8)
            db = os.path.join(root, "db")
            os.makedirs(db)
            mapf = os.path.join(db, "genome_map.out")
            with open(mapf, "w") as m:
                for g in range(5):
                    s = alpha[rng.integers(0, 4, 2000)].tobytes().decode()
                    with open(os.path.join(db, f"genome{g + 1}.fasta"), "w") as f:
                        f.write(f">g{g + 1}\n")
                        f.writelines(s[i:i + 80] + "\n" for i in range(0, 2000, 80))
                    m.write(f"genome{g + 1}.fasta\t{g + 1}\t{1000 + g}\tGenome_{g + 1}\n")
            iu, idd = os.path.join(root, "idx_u.npz"), os.path.join(root, "idx_d.npz")
            cli.main(["--device", DEV, "--build", "--both", "-f", mapf, "-D", db,
                      "-k", "20", "-L", "100", "-Lmax", "40", "-h", "20", "-i",
                      iu, idd])
            fq, truth = os.path.join(root, "reads.fq"), os.path.join(root, "truth.out")
            simulate(mapf, db, fq, truth, num_reads=4000, L=100, erate=0.01,
                     dist="lognormal", seed=0)
            kerns = (probe_bloom.KERNEL, cuckoo_verify.KERNEL, match_assemble.KERNEL,
                     case_count.KERNEL)
            for k in kerns:
                k.launches = 0
            quant = os.path.join(root, "quant.out")
            base = ["--query", "-f", mapf, "-i", iu, idd, "-q", fq, "-h", "20",
                    "-e", "0.01"]
            cli.main(["--device", "cuda", *base, "-o", quant])
            launches = {k.symbol: k.launches for k in kerns}
            log(f"toy CLI launches: {launches}")
            if not all(launches.values()):
                raise AssertionError(f"a kernel was not launched: {launches}")
            want = {}
            with open(truth) as f:
                for line in f:
                    gid, ab = line.split()
                    want[1000 + int(gid) - 1] = float(ab)
            rows = parse_quant_output(quant)[0]["rows"]
            got = {t: a for t, a, _ in rows}
            log(f"toy quant: {got} truth {want}")
            if sorted(got) != sorted(want):
                raise AssertionError(f"toy genomes {sorted(got)} != {sorted(want)}")
            worst = max(abs(got[t] - want[t]) for t in want)
            self.results["toy_max_abund_err"] = worst
            if worst > TOY_TOL:
                raise AssertionError(f"toy abundance error {worst} > {TOY_TOL}")
            t1_gpu, t1_cpu = os.path.join(root, "t1_gpu.out"), os.path.join(root, "t1_cpu.out")
            cli.main(["--device", "cuda", *base, "--read_cnts", "-o", t1_gpu])
            cli.main(["--device", "cpu", *base, "--read_cnts", "-o", t1_cpu])
            with open(t1_gpu) as a, open(t1_cpu) as b:
                g1, c1 = a.read(), b.read()
            log(f"toy Type-I:\n{g1.strip()}")
            if g1 != c1 or not g1.startswith("QUERY/TAXID"):
                raise AssertionError("Type-I output differs between cuda and cpu")
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # ---- 5. main path at config-#3 scale
    def main_path(self, art, sess, reads):
        import numpy as np
        import torch

        from cammiq_tpu_torch.config import FineParams
        from cammiq_tpu_torch.io.mapfile import Genome, GenomeTable, load_genome_lengths
        from cammiq_tpu_torch.models.quant import build_problem, solve_quant
        from cammiq_tpu_torch.query.sortjoin import TorchMergedIndex, classify_batch

        G = self.results["genomes"] + 1
        table = GenomeTable([None] + [Genome(taxid=i, name=f"g{i}")
                                      for i in range(1, G)])
        load_genome_lengths(table, art.path)
        gl, nus, nds = table.arrays()
        index_u, index_d = art.payloads()
        fine = FineParams()

        zero_counts()
        torch.cuda.synchronize()
        t = time.time()
        counts = sess.run(reads)
        prob = build_problem(index_u, index_d, counts.rcount_u, counts.rcount_d,
                             counts.cnts_u.astype(np.float64),
                             counts.cnts_d.astype(np.float64),
                             nus.astype(np.float64), nds.astype(np.float64),
                             gl, counts.mean_read_len, counts.num_reads, 0.01, fine)
        exist, cov, info = solve_quant(prob, device=sess.device)
        torch.cuda.synchronize()
        first_s = time.time() - t
        launches = read_counts("quant", self.results)
        log(f"main path (first run incl. solve): {first_s:.3f} s, maxm "
            f"{sess.maxm}, frac {sess.frac}, launches {launches}")
        self.quant_counts = counts
        assigned = int(counts.cnts_u.sum() + counts.cnts_d.sum() // 2)
        log(f"classified {assigned}/{reads.num_reads} reads; undetermined "
            f"{counts.nundet}, conflicts {counts.nconf}; quant candidates "
            f"{int(prob.exist0.sum())}, selected {int(exist.sum())}, solve "
            f"{info['solve_time']:.3f} s")
        if not (np.isfinite(cov).all() and cov.shape == (G,)
                and counts.rcount_u.shape == (art.eu,)
                and counts.nundet + counts.nconf <= reads.num_reads
                and assigned > reads.num_reads // 2):
            raise AssertionError("implausible main-path output")
        # the same pass again (maxm settled): the same counts
        c2 = sess.run(reads)
        for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
            if not np.array_equal(getattr(c2, f), getattr(counts, f)):
                raise AssertionError(f"repeat pass differs in {f}")
        self.results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        self.results["solve_s"] = info["solve_time"]
        self.results["quant_candidates"] = int(prob.exist0.sum())
        log(f"repeat pass: the same counts; max_memory_allocated "
            f"{self.results['max_memory_allocated'] / 1e9:.3f} GB")
        # one batch through the kernels (cuda) vs the plain versions (cpu)
        dm_cpu = TorchMergedIndex.from_artifact(art, "cpu")
        codes = reads.codes[:BATCH]
        lengths = reads.lengths[:BATCH]
        outs = []
        for dm in (sess.dm, dm_cpu):
            rc = torch.zeros(art.eu + art.ed, dtype=torch.int32, device=dm.device)
            bc = classify_batch(dm, torch.from_numpy(codes).to(dm.device),
                                torch.from_numpy(lengths).to(dm.device), G,
                                sess.maxm, rc, frac=sess.frac)
            outs.append([x.cpu() for x in (*bc, rc)])
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        log(f"one batch, kernels vs plain versions: identical={same}")
        if not same:
            raise AssertionError("kernel path and plain path counts differ")
        self.results["syncs"] = self.sync_check(sess, reads, G, rc.shape[0])

    def sync_check(self, sess, reads, G, nrc):
        """One batch in quant and in sc mode under sync debug mode "error"
        (a host sync raises), then the host syncs of one pass of each mode,
        counted in "warn" mode."""
        import torch

        from cammiq_tpu_torch.query.sortjoin import classify_batch

        codes = torch.from_numpy(reads.codes[:BATCH]).to(sess.device)
        lengths = torch.from_numpy(reads.lengths[:BATCH]).to(sess.device)
        rc = torch.zeros(nrc, dtype=torch.int32, device=sess.device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for sc in (False, True):
                classify_batch(sess.dm, codes, lengths, G, sess.maxm,
                               None if sc else rc, sc_mode=sc, frac=sess.frac)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sess.pair_keys()    # set-up: the pair table's one upload, before sc mode
        counts = {mode: count_syncs(lambda: sess.run(reads, sc_mode=mode == "sc"))
                  for mode in ("quant", "sc")}
        log(f"one batch in quant and sc mode under sync debug mode 'error': no "
            f"host sync; host syncs of one pass of {N_BATCHES} batches: {counts}")
        return {"batch": 0, "pass": counts}

    # ---- 6. Type-II at config-#3 scale
    def type2_main(self, art, sess, reads):
        import numpy as np
        import torch

        from cammiq_tpu_torch.config import IdentFineParams
        from cammiq_tpu_torch.models.ident import solve_ident
        from cammiq_tpu_torch.query.sortjoin import TorchMergedIndex, classify_batch

        G = self.results["genomes"] + 1
        want = self.quant_counts
        zero_counts()
        torch.cuda.synchronize()
        t = time.time()
        counts = sess.run(reads, sc_mode=True)
        pass_s = time.time() - t
        launches = read_counts("typeII", self.results)
        self.sc_counts = counts
        for f in ("cnts_u", "cnts_d"):
            if not np.array_equal(getattr(counts, f), getattr(want, f)):
                raise AssertionError(f"sc-mode {f} differs from the quant pass")
        if (counts.nundet, counts.nconf) != (want.nundet, want.nconf):
            raise AssertionError("sc-mode nundet/nconf differ from the quant pass")
        P = int(sess.pair_keys().shape[0])
        paired = sum(counts.pair_counts.values())
        t = time.time()
        exist, redist = solve_ident(counts.cnts_u, counts.cnts_d,
                                    counts.pair_counts, IdentFineParams())
        ident_s = time.time() - t
        if not (redist.shape == (G,) and np.isfinite(redist).all()):
            raise AssertionError("implausible solve_ident output")
        if sess.run(reads, sc_mode=True).pair_counts != counts.pair_counts:
            raise AssertionError("repeat sc-mode pass differs in pair_counts")
        self.results["typeII"] = {
            "pair_table": P, "pairs_hit": len(counts.pair_counts),
            "pair_assigned_reads": paired, "first_pass_s": pass_s,
            "ident_s": ident_s, "ident_exist": int(np.sum(exist)),
            "launches": launches}
        log(f"Type-II pass: P={P} pairs in the table, {len(counts.pair_counts)} "
            f"hit, {paired} pair-assigned reads; first pass {pass_s:.3f} s, a "
            f"second the same pair counts; solve_ident {ident_s:.3f} s, "
            f"{int(np.sum(exist))} genomes; launches {launches}")
        # one batch through the kernels (cuda) vs the plain versions (cpu)
        dm_cpu = TorchMergedIndex.from_artifact(art, "cpu")
        outs = []
        for dm in (sess.dm, dm_cpu):
            bc = classify_batch(dm, torch.from_numpy(reads.codes[:BATCH]).to(dm.device),
                                torch.from_numpy(reads.lengths[:BATCH]).to(dm.device),
                                G, sess.maxm, sc_mode=True, frac=sess.frac)
            outs.append([x.cpu() for x in bc])
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        npair = int((outs[0][5] >= 0).sum())
        log(f"one sc-mode batch, kernels vs plain versions: identical={same}, "
            f"{npair} pair-assigned reads")
        if not same:
            raise AssertionError("sc-mode batch outputs differ kernels vs plain")

    # ---- 10. toy Type-II and the build through the CLI, cuda against cpu
    def toy_type2(self):
        import numpy as np
        import torch

        from cammiq_tpu_torch import cli
        from cammiq_tpu_torch.config import QueryConfig
        from cammiq_tpu_torch.index.table import load_flat_index, load_flat_index_pair
        from cammiq_tpu_torch.io.fastq import read_fastq
        from cammiq_tpu_torch.query.pipeline import QuerySession
        from cammiq_tpu_torch.tools.simulate import simulate

        os.makedirs(OUT_DIR, exist_ok=True)
        root = tempfile.mkdtemp(prefix="smoke_pairs_", dir=OUT_DIR)
        try:
            rng = np.random.default_rng(5)
            gs = [rng.integers(0, 4, 2000) for _ in range(5)]
            for g in range(5):            # a segment in genomes g and g + 1
                seg = rng.integers(0, 4, 300)
                for h in (g, (g + 1) % 5):
                    at = int(rng.integers(0, 1700))
                    gs[h][at:at + 300] = seg
            alpha = np.frombuffer(b"ACGT", np.uint8)
            db = os.path.join(root, "db")
            os.makedirs(db)
            mapf = os.path.join(db, "genome_map.out")
            with open(mapf, "w") as m:
                for g, x in enumerate(gs):
                    seq = alpha[x].tobytes().decode()
                    with open(os.path.join(db, f"genome{g + 1}.fasta"), "w") as f:
                        f.write(f">g{g + 1}\n")
                        f.writelines(seq[i:i + 80] + "\n" for i in range(0, 2000, 80))
                    m.write(f"genome{g + 1}.fasta\t{g + 1}\t{1000 + g}\tGenome_{g + 1}\n")
            flags = ["--both", "-f", mapf, "-D", db, "-k", "20", "-L", "100",
                     "-Lmax", "40", "-h", "20"]
            idx = {}
            for dev in ("cpu", DEV):
                d = os.path.join(root, dev)
                zero_counts()
                cli.main(["--device", dev, "--build", *flags, "-i",
                          os.path.join(d, "index_u.npz"), os.path.join(d, "index_d.npz")])
                if dev == DEV:
                    log(f"toy device build launches: "
                        f"{read_counts('build', {})}")
                idx[dev] = d
            for f in ("index_u.npz", "index_d.npz"):
                assert_same_index(*(load_flat_index(os.path.join(idx[k], f))
                                    for k in (DEV, "cpu")), f"toy build {f}")
            for f in META_FILES:
                with open(os.path.join(idx["cpu"], f)) as a, \
                        open(os.path.join(idx[DEV], f)) as b:
                    if a.read() != b.read():
                        raise AssertionError(f"toy device build differs: {f}")
            iu, idd = (os.path.join(idx[DEV], f) for f in ("index_u.npz", "index_d.npz"))
            fq = os.path.join(root, "reads.fq")
            simulate(mapf, db, fq, os.path.join(root, "truth.out"), num_reads=3000,
                     L=100, erate=0.01, dist="uniform", seed=3)
            index_u, index_d = load_flat_index_pair(iu, idd)
            pc = QuerySession(index_u, index_d, 6, QueryConfig(h=20),
                              device=DEV).run(read_fastq(fq), sc_mode=True).pair_counts
            log(f"toy pair counts: {pc}")
            if not pc or max(pc.values()) <= 0:
                raise AssertionError("toy pair counts are empty")
            base = ["--query", "--read_cnts", "--doubly_unique", "-f", mapf,
                    "-i", iu, idd, "-q", fq, "-e", "0.01"]
            outs = {}
            for dev in (DEV, "cpu"):
                out = os.path.join(root, f"t2_{dev}.out")
                cli.main(["--device", dev, *base, "-o", out])
                with open(out) as f:
                    outs[dev] = f.read()
            log(f"toy Type-II:\n{outs[DEV].strip()}")
            if outs[DEV] != outs["cpu"] or not outs[DEV].startswith("QUERY/TAXID"):
                raise AssertionError("Type-II output differs between cuda and cpu")
            self.results["toy_pair_counts"] = {f"{a},{b}": c for (a, b), c in pc.items()}
            torch.cuda.synchronize()
            # phase 14 round-trips this index through the reference format
            self.toy_pairs = {"root": root, "mapf": mapf, "fq": fq, "iu": iu,
                              "idd": idd, "pair_counts": pc, "type2": outs[DEV]}
        finally:
            if self.toy_pairs is None:
                shutil.rmtree(root, ignore_errors=True)

    # ---- 11. the device build against the CPU build at a reduced size
    def build_vs_cpu(self):
        from cammiq_tpu_torch.config import BuildConfig
        from cammiq_tpu_torch.index.builder import build_index
        from cammiq_tpu_torch.io.fasta import corpus_from_sequences
        from cammiq_tpu_torch.tools.benchdata import BENCH_GLEN, gen_genomes

        corpus = corpus_from_sequences(gen_genomes(BUILD_CHECK_GENOMES, BENCH_GLEN))
        cfg = BuildConfig(k=26, L=100, Lmax=50, h=26, mode="both")
        arts, secs = {}, {}
        for dev in (DEV, "cpu"):
            zero_counts()
            t = time.time()
            with contextlib.redirect_stderr(io.StringIO()):
                arts[dev] = build_index(corpus, cfg, device=dev, verbose=True)
            secs[dev] = time.time() - t
            if dev == DEV:
                launches = read_counts("build_check", self.results)
        got, want = arts[DEV], arts["cpu"]
        assert_same_artifacts(got, want, "build cuda vs cpu")
        stages = {d: a.timings.as_dict() for d, a in arts.items()}
        self.results["build_vs_cpu"] = {
            "genomes": BUILD_CHECK_GENOMES, "n": corpus.n, "build_s": secs,
            "stages_s": stages, "launches": launches,
            "entries": (got.unique_index.num_entries, got.doubly_index.num_entries)}
        # phase 13 holds the host engines to this cuda build
        self.build_check = (corpus, cfg, got, secs[DEV], launches)
        log(f"build of n={corpus.n} ({BUILD_CHECK_GENOMES} genomes): cuda "
            f"{secs[DEV]:.1f} s, cpu {secs['cpu']:.1f} s; both tables "
            f"({got.unique_index.num_entries}, {got.doubly_index.num_entries} "
            f"entries), ulm counts and meta files identical; launches of the cuda "
            f"build {launches}; stages (cuda | cpu):\n"
            + stage_table(stages[DEV], {}, stages["cpu"]))

    # ---- 13. the host build engines against the device build on cuda
    def host_engines(self):
        import dataclasses

        from cammiq_tpu_torch import native
        from cammiq_tpu_torch.index.builder import build_index

        if not (native.available() and native.has_bsort()):
            raise RuntimeError(f"native bounded sort unavailable: {native.build_error()}")
        corpus, cfg, dev_art, dev_s, launches = self.build_check
        out = {"n": corpus.n, "cpu_count": os.cpu_count(), "cpu_model": cpu_model(),
               "device_build_s": dev_s, "device_launches": launches,
               "device_stages_s": dev_art.timings.as_dict()}
        log(f"host: {out['cpu_model']}, os.cpu_count() = {out['cpu_count']}")
        # (a) the bounded sort, (b) SA-IS (--exact_sa), each on the host
        for tag, bounded, want in (("native_bounded", True, "native bounded sort"),
                                   ("native_sais", False, "native SA-IS")):
            err = io.StringIO()
            t = time.time()
            with contextlib.redirect_stderr(err):
                art = build_index(corpus, dataclasses.replace(cfg, bounded_sa=bounded),
                                  engine="native", verbose=True)
            secs = time.time() - t
            if f"build engine: {want}, host" not in err.getvalue():
                raise AssertionError(f"{tag}: engine line missing: {err.getvalue()[:300]}")
            assert_same_artifacts(art, dev_art, f"{tag} vs cuda build")
            out[tag] = {"build_s": secs, "stages_s": art.timings.as_dict()}
            log(f"{tag} host build of n={corpus.n} ({BUILD_CHECK_GENOMES} genomes): "
                f"{secs:.1f} s against the cuda build's {dev_s:.1f} s; index, ulm counts "
                f"and meta files identical; stages (host | cuda):\n"
                + stage_table(art.timings.as_dict(), {}, dev_art.timings.as_dict(), "cuda"))
            del art
        # (c) the cross-host build through the CLI, in a process of its own
        # (its workers' peak RSS starts from their coordinator's, which Linux
        # carries across exec), 2 slices in worker processes, at a cut
        # corpus: its P3 sweep is one serial worker with a Python loop a run
        root = os.path.join(REPO, "bench_cache", "smoke_dist_build")
        shutil.rmtree(root, ignore_errors=True)
        try:
            out["dist"] = self._cross_host_build(root, cfg)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        self.results["host_engines"] = out

    def _cross_host_build(self, root, cfg) -> dict:
        import dataclasses

        import numpy as np

        from cammiq_tpu_torch.index.builder import build_index, save_index
        from cammiq_tpu_torch.io.fasta import build_corpus
        from cammiq_tpu_torch.tools.benchdata import BENCH_GLEN, gen_genomes

        db = os.path.join(root, "fasta")
        os.makedirs(db)
        files = []
        with open(os.path.join(root, "map.out"), "w") as m:
            for g, (seq,) in enumerate(gen_genomes(DIST_GENOMES, BENCH_GLEN)):
                with open(os.path.join(db, f"g{g:02d}.fasta"), "wb") as f:
                    f.write(b">g%d\n%s\n" % (g, seq))
                m.write(f"g{g:02d}.fasta\t{g + 1}\t{g + 1}\tG{g}\n")
                files.append((os.path.join(db, f"g{g:02d}.fasta"), g + 1))
        ours = os.path.join(root, "dist")
        tmp = os.path.join(root, "tmp")
        os.makedirs(tmp)
        argv = [sys.executable, "-m", "cammiq_tpu_torch.cli", "--build", "--both",
                "-k", str(cfg.k), "-L", str(cfg.L), "-Lmax", str(cfg.Lmax),
                "-h", str(cfg.h), "-f", os.path.join(root, "map.out"), "-D", db + "/",
                "--build_hosts", "2", "-i", os.path.join(ours, "index_u.npz"),
                os.path.join(ours, "index_d.npz")]
        # through a shell that waits on it: a process forked from this one
        # and exec'd would start its peak RSS at this process's (Linux
        # carries ru_maxrss across exec), and the coordinator's peak is P3's
        t = time.time()
        r = subprocess.run(["/bin/sh", "-c", '"$@"; exit $?', "sh", *argv], cwd=REPO,
                           capture_output=True, text=True, timeout=600,
                           env=dict(os.environ, PYTHONPATH=REPO, TMPDIR=tmp))
        dist_s = time.time() - t
        if r.returncode:
            raise RuntimeError(f"cross-host build failed: {r.stderr[-3000:]}")
        if "build engine: cross-host, 2 slices" not in r.stderr or os.listdir(tmp):
            raise AssertionError(f"cross-host build: engine line or work dir: {r.stderr[-2000:]}")
        rss = {m.group(1): json.loads(m.group(2)) for m in re.finditer(
            r"\[dist-build\] (\w+): peak RSS MB per worker = (\[.*?\])", r.stderr)}
        if sorted(rss) != sorted(("baseline", "p1_sort_partition", "p2_merge_chunks",
                                  "p3_sweeps", "p4_select")):
            raise AssertionError(f"cross-host build: RSS report {rss}")
        # the reference: the device build on cuda of the same corpus with
        # the selection groups the 2 text shards give (num_groups=2)
        corpus = build_corpus(sorted(files))
        t = time.time()
        with contextlib.redirect_stderr(io.StringIO()):
            want = build_index(corpus, dataclasses.replace(cfg, num_groups=2),
                               device=DEV, verbose=True)
        dev_s = time.time() - t
        save_index(want, os.path.join(root, "cuda"))
        for name in ("index_u.npz", "index_d.npz"):
            with np.load(os.path.join(ours, name)) as a, \
                    np.load(os.path.join(root, "cuda", name)) as b:
                if sorted(a.files) != sorted(b.files) or not all(
                        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                        for k in b.files):
                    raise AssertionError(f"cross-host build vs cuda build: {name} differs")
        for f in META_FILES:
            with open(os.path.join(ours, f)) as a, open(os.path.join(root, "cuda", f)) as b:
                if a.read() != b.read():
                    raise AssertionError(f"cross-host build vs cuda build: {f} differs")
        # the phases' seconds: the same build in this process, its workers
        # run in turn (processes=False) and timed one by one
        import cammiq_tpu_torch.parallel.dist_build as db

        phase_s = {}
        originals = {w: getattr(db, w) for w in
                     ("_p1_worker", "_p2_worker", "_p3_worker", "_p4_worker")}

        def timed(name, fn):
            def run(args):
                t = time.time()
                try:
                    return fn(args)
                finally:
                    phase_s[name] = phase_s.get(name, 0.0) + time.time() - t
            return run

        for w, fn in originals.items():
            setattr(db, w, timed(w[1:3], fn))
        t = time.time()
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                again, _ = db.dist_build_index(corpus, cfg, 2,
                                               os.path.join(root, "serial"),
                                               processes=False)
        finally:
            for w, fn in originals.items():
                setattr(db, w, fn)
        serial_s = time.time() - t
        assert_same_artifacts(again, want, "serial cross-host build vs cuda build")
        base = max(rss["baseline"])
        log(f"the same build in one process, workers in turn: {serial_s:.1f} s; "
            f"seconds by phase (the rest is the coordinator's): "
            + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
        log(f"cross-host build (cli --build_hosts 2, worker processes) of n={corpus.n} "
            f"({DIST_GENOMES} genomes, cut from {BUILD_CHECK_GENOMES} for its serial P3 "
            f"sweep): {dist_s:.1f} s in all, against the cuda build's {dev_s:.1f} s "
            f"(num_groups=2); tables and meta files identical; peak RSS MB per worker "
            f"(baseline: a worker that only starts, {base:.1f} MB; P3, one job, runs "
            f"in the coordinator, so its number is the coordinator's peak):\n"
            + "\n".join(f"  {k:<18} {vs}" for k, vs in rss.items()))
        return {"genomes": DIST_GENOMES, "n": corpus.n, "hosts": 2, "cli_s": dist_s,
                "device_build_s": dev_s, "rss_mb": rss, "serial_s": serial_s,
                "serial_phase_s": phase_s}

        self.results["host_engines"] = out

    # ---- 12. build kernels vs plain versions on the build's tensors
    def build_kernels(self):
        import numpy as np
        import torch

        from cammiq_tpu_torch.index import unique as uq
        from cammiq_tpu_torch.io.fasta import corpus_from_sequences
        from cammiq_tpu_torch.kernels import first_of_run as kfr
        from cammiq_tpu_torch.kernels import lcp_pairs as klcp
        from cammiq_tpu_torch.kernels import occ_count as kocc
        from cammiq_tpu_torch.kernels import segmented_min as ksm
        from cammiq_tpu_torch.ops.sa import suffix_array
        from cammiq_tpu_torch.tools.benchdata import (BENCH_GENOMES, BENCH_GLEN,
                                                      gen_genomes)

        corpus = corpus_from_sequences(gen_genomes(BENCH_GENOMES, BENCH_GLEN))
        dev = torch.device(DEV)
        text = torch.from_numpy(np.array(corpus.seq, np.uint8)).to(dev)
        sa = suffix_array(text)
        lcp = klcp.lcp_pairs(text, sa)
        gsa = uq.compute_gsa(sa, corpus.ref_pos, corpus.ref_id)
        del corpus
        n = gsa.shape[0]
        torch.cuda.synchronize()
        full = 5, 1, 1      # reps, inner, warmup: full-n kernels
        once = 1, 1, 0      # the plain versions at full n: one timed call

        # first_of_run at the build's n, every mode: run_info's starts/ends
        starts = torch.ones(n, dtype=torch.bool, device=dev)
        starts[1:] = gsa[1:] != gsa[:-1]
        ends = torch.ones(n, dtype=torch.bool, device=dev)
        ends[:-1] = starts[1:]
        for flags, rev in ((starts, False), (ends, True)):
            tag = "rt" if rev else "rb"
            self.compare(f"first_of_run@build_n index {tag}", kfr.first_of_run_scan,
                         kfr.first_of_run_scan_plain, (flags,),
                         bound_first_of_run(flags), full, once, reverse=rev)
            self.compare(f"first_of_run@build_n values {tag}", kfr.first_of_run_scan,
                         kfr.first_of_run_scan_plain, (flags, gsa),
                         bound_first_of_run(flags, gsa), full, once, reverse=rev)
        # segmented_min as _direction_mins calls it: lcp[:n] with the run
        # starts, lcp[1:n+1] (4 bytes past a 16-byte boundary) with the ends
        for name, args, rev in (("segmented_min", (lcp[:n], starts), False),
                                ("segmented_min@rev", (lcp[1:n + 1], ends), True)):
            self.compare(name, ksm.segmented_min, ksm.segmented_min_plain, args,
                         bound_segmented_min(*args), full, once, reverse=rev)
        del starts, ends
        lcp0 = uq.unique_lcp0(gsa, lcp, 25)
        dl, g2 = uq.doubly_lcp0(sa, gsa, lcp, 25, 100)
        g2 = g2[sa.long()]
        # full-n kernel times beside their bounds, then a slice of SLICE
        # ranks around the longest LCP for kernel vs plain
        end_excl = int(torch.argmax((gsa != gsa[0]).to(torch.uint8))) - 1
        fulls = {
            "lcp_pairs": (lambda: klcp.lcp_pairs(text, sa),
                          bound_lcp_pairs(text, sa, lcp)),
            "occ_count": (lambda: kocc.occ_count_unique(lcp, lcp0, gsa),
                          bound_occ_unique(lcp, lcp0, gsa)),
            "occ_count_doubly": (
                lambda: kocc.occ_count_doubly(lcp, dl, gsa, g2, 100, end_excl),
                bound_occ_doubly(lcp, dl, gsa, g2, 100, end_excl)),
        }
        full_n = {}
        for name, (fn, bnd) in fulls.items():
            ms = cuda_median_ms(fn, *full)
            full_n[name] = {"ms": ms, **bnd}
            log(f"{name} at full n={n}: {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}: {bnd['bytes']} B, {bnd['ops']} ops) -> "
                f"{100 * bnd['bound_ms'] / ms:.1f}% of bound")
        # the thread phase alone: with clamp 32 no pair reaches the warp phase
        ms = cuda_median_ms(lambda: klcp.lcp_pairs(text, sa, 32), *full)
        full_n["lcp_pairs"]["thread_phase_ms"] = ms
        log(f"lcp_pairs at full n, clamp 32 (thread phase only): {ms:.4f} ms")
        self.results["build_kernels_full_n"] = full_n
        top = int(torch.argmax(lcp))
        lo = max(0, min(top - SLICE // 2, n - SLICE))
        hi = lo + SLICE
        self.results["build_kernel_slice"] = {"lo": lo, "hi": hi, "max_lcp": int(lcp[top]),
                                              "max_lcp_in_slice": int(lcp[lo + 1:hi].max())}
        log(f"kernel slice: ranks [{lo}, {hi}) of {n}; longest LCP {int(lcp[top])} "
            f"at rank {top}")
        s_sa = sa[lo:hi].contiguous()
        s_lcp = lcp[lo:hi + 1].contiguous()
        s_lcp[0] = s_lcp[-1] = 0          # lcp_pairs of the slice alone
        slow = 5, 1, 1, 3, 1, 0
        self.compare("lcp_pairs", klcp.lcp_pairs, klcp.lcp_pairs_plain,
                     (text, s_sa), bound_lcp_pairs(text, s_sa, s_lcp),
                     slow[:3], slow[3:])
        s_lcp = lcp[lo:hi + 1].contiguous()
        s_gsa = gsa[lo:hi].contiguous()
        self.compare("occ_count", kocc.occ_count_unique, kocc.occ_count_unique_plain,
                     (s_lcp, lcp0[lo:hi].contiguous(), s_gsa),
                     bound_occ_unique(s_lcp, lcp0[lo:hi], s_gsa), slow[:3], slow[3:])
        s_other = s_gsa != s_gsa[0]
        s_end = int(torch.argmax(s_other.to(torch.uint8))) - 1 if bool(s_other.any()) else SLICE - 1
        d_args = (s_lcp, dl[lo:hi].contiguous(), s_gsa, g2[lo:hi].contiguous(), 100,
                  s_end)
        self.compare("occ_count_doubly", kocc.occ_count_doubly,
                     kocc.occ_count_doubly_plain, d_args, bound_occ_doubly(*d_args),
                     slow[:3], slow[3:])

    # ---- 8. distributed query: a world-of-one NCCL grid, two shards on one card
    def grid(self, art, sess, reads):
        import numpy as np
        import torch
        import torch.distributed as dist

        from cammiq_tpu_torch.config import QueryConfig
        from cammiq_tpu_torch.parallel.mesh import ProcessGrid
        from cammiq_tpu_torch.query.pipeline import QuerySession

        G = self.results["genomes"] + 1
        out = self.results["grid"] = {}
        store = dist.TCPStore("127.0.0.1", free_port(), 1, True,
                              timeout=datetime.timedelta(seconds=120))
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            grid = ProcessGrid(1, 1, sess.device)
            t = time.time()
            gsess = QuerySession.from_artifact(
                art, G, QueryConfig(h=art.h, erate=0.01, batch_size=BATCH),
                device=DEV, grid=grid)
            torch.cuda.synchronize()
            out["grid_session_start_s"] = time.time() - t
            out["grid_geometry"] = gsess.dist.geometry
            gsess.run(reads)                    # NCCL set-up, maxm settled
            zero_counts()
            counts = gsess.run(reads)
            out["launches"] = read_counts("grid", self.results)
            sc = gsess.run(reads, sc_mode=True)
            for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
                if not np.array_equal(getattr(counts, f),
                                      getattr(self.quant_counts, f)):
                    raise AssertionError(f"grid quant pass differs in {f}")
            for c, want, mode in ((counts, self.quant_counts, "quant"),
                                  (sc, self.sc_counts, "sc")):
                if (c.nundet, c.nconf, c.pair_counts) != (
                        want.nundet, want.nconf, want.pair_counts):
                    raise AssertionError(f"grid {mode} pass differs")
            if not np.array_equal(sc.cnts_d, self.sc_counts.cnts_d):
                raise AssertionError("grid sc pass differs in cnts_d")
            # a grid batch under sync debug mode "error", then a pass's syncs
            codes = torch.from_numpy(reads.codes[:BATCH]).to(sess.device)
            lengths = torch.from_numpy(reads.lengths[:BATCH]).to(sess.device)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for scm in (False, True):
                    gsess.dist.classify_batch(codes, lengths, G, gsess.maxm,
                                              sc_mode=scm, frac=gsess.frac)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out["syncs"] = {"batch": 0, "pass": {
                m: count_syncs(lambda: gsess.run(reads, sc_mode=m == "sc"))
                for m in ("quant", "sc")}}
            if out["syncs"]["pass"] != {"quant": 1, "sc": 1}:
                raise AssertionError(f"grid pass syncs {out['syncs']}")
            log(f"world-of-one NCCL grid (1 x 1): session start "
                f"{out['grid_session_start_s']:.1f} s, shard "
                f"{out['grid_geometry']}; quant and sc counts equal the single "
                f"session's; launches {out['launches']}; no host sync in a "
                f"quant or sc batch, a pass's syncs {out['syncs']['pass']}")
            del gsess
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        self.two_shards(art, sess, reads)

    def two_shards(self, art, sess, reads):
        """Two model shards of the index on the one card, probed through
        the kernels, their slots concatenated as a row's gather gives
        them: the counts of a pass equal the unsharded session's."""
        import numpy as np
        import torch

        from cammiq_tpu_torch.kernels import cuckoo_verify as kcv
        from cammiq_tpu_torch.kernels import probe_bloom as kpb
        from cammiq_tpu_torch.parallel import dist_query as dq
        from cammiq_tpu_torch.query.classify import MatchSlots, case_count
        from cammiq_tpu_torch.query.sortjoin import collect_matches

        G = self.results["genomes"] + 1
        out = self.results["grid"]
        src = dq._MergedSource.from_artifact(art)
        t = time.time()
        cuts = dq.shard_merged_cuts(src, 2)
        shards = [dq.shard_index(src, i, cuts, sess.device) for i in range(2)]
        torch.cuda.synchronize()
        out["two_shard_build_s"] = time.time() - t
        _, e_lo, e_hi, e_pad, nb_pad, bloom_log, ck_log = cuts
        out["two_shard_geometry"] = {
            "e_pad": e_pad, "nb_pad": nb_pad, "bloom_log": bloom_log,
            "device_bloom_log": shards[0].bloom_log, "ck_log": ck_log,
            "entries": [h - l for l, h in zip(e_lo, e_hi)]}
        log(f"two shards of E={art.E}, NB={art.NB} built in "
            f"{out['two_shard_build_s']:.1f} s: {out['two_shard_geometry']}")
        dev = sess.device
        # (cnts_u | cnts_d | nundet | nconf), the layout case_count adds to
        acc = {k: torch.zeros(n, dtype=torch.int32, device=dev) for k, n in
               (("counts", 2 * G + 2), ("ovs", 1), ("ovh", 1),
                ("rcount", art.eu + art.ed))}

        def batch(codes, lengths):
            mts = [collect_matches(dm, codes, lengths, sess.maxm, sess.frac)
                   for dm in shards]
            slots = MatchSlots(*(torch.cat([getattr(mt.slots, f) for mt in mts], 1)
                                 for f in MatchSlots._fields))
            case_count(slots, lengths, G, rcount=acc["rcount"],
                       counts=acc["counts"])
            for mt in mts:
                acc["ovs"] += mt.overflow_slots
                acc["ovh"] += mt.overflow_hits
            return slots

        zero_counts()
        for b in reads.batches(BATCH):
            batch(torch.from_numpy(b.codes).to(dev).contiguous(),
                  torch.from_numpy(b.lengths).to(dev))
        torch.cuda.synchronize()
        out["two_shard_launches"] = read_counts("shards", self.results)
        host = {k: v.cpu().numpy() for k, v in acc.items()}
        want = self.quant_counts
        if int(host["ovs"][0]) or int(host["ovh"][0]):
            raise AssertionError(f"two shards overflowed: {host['ovs']}, {host['ovh']}")
        rc, cnt = host["rcount"].astype(np.int64), host["counts"]
        for f, got in (("cnts_u", cnt[:G]), ("cnts_d", cnt[G:2 * G]),
                       ("rcount_u", rc[:art.eu]), ("rcount_d", rc[art.eu:])):
            if not np.array_equal(got, getattr(want, f)):
                raise AssertionError(f"two shards differ in {f}")
        if (int(cnt[2 * G]), int(cnt[2 * G + 1])) != (want.nundet, want.nconf):
            raise AssertionError("two shards differ in nundet/nconf")
        log(f"two shards, {N_BATCHES} batches through the kernels, slots "
            f"concatenated: counts equal the unsharded session's; launches "
            f"{out['two_shard_launches']}")
        # each kernel at the second shard's shapes, beside its time on the
        # whole index; case_count at the row's concatenated width
        codes = torch.from_numpy(reads.codes[:BATCH]).to(dev).contiguous()
        lengths = torch.from_numpy(reads.lengths[:BATCH]).to(dev)
        captured = capture_kernel_calls(lambda: batch(codes, lengths))
        self.case_count_vs_plain("case_count@shards", batch(codes, lengths),
                                 lengths, G, art.eu + art.ed)
        pb_args, (_, _, n) = captured["probe_bloom"]
        cv_args, cv_out = captured["cuckoo_verify"]
        ma_args, _ = captured["match_assemble"]
        log(f"second shard, one batch: {n.item()} survivors, "
            f"{cv_out[2].tolist()} matches (found, beyond KP = {cv_args[-1]})")
        self.compare("probe_bloom@shard", kpb.probe_bloom, kpb.probe_bloom_plain,
                     pb_args, bound_probe_bloom(*pb_args, n), canon=probe_canon)
        self.compare("cuckoo_verify@shard", kcv.cuckoo_verify,
                     kcv.cuckoo_verify_plain, cv_args,
                     bound_cuckoo_verify(cv_args, cv_out), canon=match_canon)
        self.match_assemble_vs_plain("match_assemble@shard", ma_args)
        for k in ("probe_bloom", "cuckoo_verify", "match_assemble"):
            full, shard = self.kernels.get(k, {}), self.kernels[f"{k}@shard"]
            log(f"{k}: whole index {full.get('ms')} ms (device only "
                f"{full.get('device_ms')}), second of two shards {shard['ms']:.4f} ms "
                f"(device only {shard['device_ms']})")

    # ---- 9. the gather engine: session and kernel
    def gather_engine(self, mdir, sess, reads):
        import numpy as np
        import torch

        from cammiq_tpu_torch.config import QueryConfig
        from cammiq_tpu_torch.index.table import load_flat_index_pair
        from cammiq_tpu_torch.kernels import gather_probe as kgp
        from cammiq_tpu_torch.query import classify as gc
        from cammiq_tpu_torch.query import probe as gprobe
        from cammiq_tpu_torch.query.pipeline import QuerySession

        G = self.results["genomes"] + 1
        out = self.results["gather"] = {}
        cdir = os.path.dirname(mdir)
        t = time.time()
        index_u, index_d = load_flat_index_pair(os.path.join(cdir, "index_u.npz"),
                                                os.path.join(cdir, "index_d.npz"))
        gsess = QuerySession(index_u, index_d, G,
                             QueryConfig(h=index_u.h, erate=0.01, batch_size=BATCH),
                             device=DEV, engine="gather")
        torch.cuda.synchronize()
        out["session_start_s"] = time.time() - t
        du, dd = gsess.didx_u, gsess.didx_d
        out["tables"] = {n: {"entries": x.num_entries, "table_rows": 1 << x.table_bits,
                             "max_probes": x.max_probes, "max_bucket": x.max_bucket,
                             "kw": x.kw} for n, x in (("unique", du), ("doubly", dd))}
        t = time.time()
        gprobe.check_probe_runs(index_u.table_lo, index_u.table_hi, index_u.table_start)
        out["probe_runs_check_s"] = time.time() - t
        log(f"gather session start {out['session_start_s']:.1f} s (npz load "
            f"included): tables {out['tables']}; the unique table's probe-run "
            f"check at staging {out['probe_runs_check_s']:.3f} s")
        zero_counts()
        counts = gsess.run(reads)
        out["launches"] = read_counts("gather", self.results)
        sc = gsess.run(reads, sc_mode=True)
        for c, want, mode in ((counts, self.quant_counts, "quant"),
                              (sc, self.sc_counts, "sc")):
            for f in ("cnts_u", "cnts_d") + (("rcount_u", "rcount_d") if mode == "quant" else ()):
                if not np.array_equal(getattr(c, f), getattr(want, f)):
                    raise AssertionError(f"gather {mode} pass differs from the sort join in {f}")
            if (c.nundet, c.nconf, c.pair_counts) != (want.nundet, want.nconf,
                                                     want.pair_counts):
                raise AssertionError(f"gather {mode} pass differs from the sort join")
        log(f"gather quant and sc passes: counts, rcounts and pair counts equal "
            f"the sort join's; launches {out['launches']}")
        # a batch in each mode under sync debug mode "error", a pass's syncs
        codes = torch.from_numpy(reads.codes[:BATCH]).to(sess.device).contiguous()
        lengths = torch.from_numpy(reads.lengths[:BATCH]).to(sess.device)
        rc = torch.zeros(gsess._rc_size, dtype=torch.int32, device=sess.device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for scm in (False, True):
                gc.classify_batch(du, dd, codes, lengths, G, None if scm else rc,
                                  sc_mode=scm)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["syncs"] = {"batch": 0, "pass": {
            m: count_syncs(lambda: gsess.run(reads, sc_mode=m == "sc"))
            for m in ("quant", "sc")}}
        if out["syncs"]["pass"] != {"quant": 1, "sc": 1}:
            raise AssertionError(f"gather pass syncs {out['syncs']}")
        # the kernel against its plain version on one batch's tensors
        args = (du, dd, codes, lengths)
        got = kgp.gather_probe(*args)
        hits = int((got[0] < kgp.BIG).sum())
        log(f"gather batch: {hits} matched slots of {got[0].numel()} "
            f"({BATCH} x {got[0].shape[1]})")
        bnd = bound_gather_probe(*args, got)
        log(f"gather_probe: mean table rows walked per probe (to the hit or "
            f"the first empty row) {bnd['rows_walked_mean']}")
        self.compare("gather_probe", kgp.gather_probe, kgp.gather_probe_plain,
                     args, bnd, plain_reps=(3, 1, 1))
        self.case_count_vs_plain("case_count@gather", gc.MatchSlots(*got), lengths,
                                 G, gsess._rc_size)

    # ---- 14. index formats on the card
    def formats_reference(self):
        """(a) The cuda build at DIST_GENOMES through the reference's
        .bin1/.bin2 files and back, then queried on the card by both
        engines against the original pair."""
        import numpy as np

        from cammiq_tpu_torch.config import BuildConfig, QueryConfig
        from cammiq_tpu_torch.index.builder import build_index
        from cammiq_tpu_torch.index.refcompat import (reference_index_to_flat,
                                                      write_reference_index)
        from cammiq_tpu_torch.io.fasta import corpus_from_sequences
        from cammiq_tpu_torch.io.fastq import ReadSet
        from cammiq_tpu_torch.query.pipeline import QuerySession
        from cammiq_tpu_torch.tools.benchdata import BENCH_GLEN, gen_genomes

        out = self.results.setdefault("index_formats", {})
        genomes = gen_genomes(DIST_GENOMES, BENCH_GLEN)
        t = time.time()
        with contextlib.redirect_stderr(io.StringIO()):
            art = build_index(corpus_from_sequences(genomes),
                              BuildConfig(k=26, L=100, Lmax=50, h=26, mode="both"),
                              device=DEV)
        build_s = time.time() - t
        orig = (art.unique_index, art.doubly_index)
        root = tempfile.mkdtemp(prefix="smoke_refcompat_", dir=OUT_DIR)
        try:
            paths = [os.path.join(root, n) for n in ("index.bin1", "index.bin2")]
            t = time.time()
            for p, ix in zip(paths, orig):
                write_reference_index(p, ix)
            write_s = time.time() - t
            nbytes = sum(os.path.getsize(p) + os.path.getsize(p + ".aux") for p in paths)
            t = time.time()
            imported = tuple(reference_index_to_flat(p, Lmax=50) for p in paths)
            read_s = time.time() - t
        finally:
            shutil.rmtree(root, ignore_errors=True)
        for name, got, want in zip(("unique", "doubly"), imported, orig):
            if not np.array_equal(entry_rows(got), entry_rows(want)):
                raise AssertionError(f"reference-format round trip: {name} entries differ")
        entries = [ix.num_entries for ix in orig]
        log(f"cuda build of {DIST_GENOMES} genomes in {build_s:.1f} s, entries "
            f"{entries}; reference format written in {write_s:.3f} s ({nbytes} B), "
            f"read back in {read_s:.3f} s on the host ({cpu_model()}); entry "
            f"sets equal")
        reads = sample_reads(genomes, REF_BATCHES, 14)
        G = DIST_GENOMES + 1
        cfg = QueryConfig(h=26, erate=0.01, batch_size=BATCH)
        sessions = {(e, src): QuerySession(*pair, G, cfg, device=DEV, engine=e)
                    for e in ENGINES
                    for src, pair in (("imported", imported), ("original", orig))}
        zero_counts()
        counts = {(key, mode): sess.run(reads, sc_mode=mode == "sc")
                  for key, sess in sessions.items() for mode in ("quant", "sc")}
        launches = read_counts("refcompat", self.results)
        for e in ENGINES:
            for mode in ("quant", "sc"):
                got, want = (counts[(e, src), mode] for src in ("imported", "original"))
                what = f"imported vs original pair, {e} {mode}"
                for f in ("cnts_u", "cnts_d"):
                    if not np.array_equal(getattr(got, f), getattr(want, f)):
                        raise AssertionError(f"{what}: {f} differs")
                if (got.nundet, got.nconf, got.pair_counts) != (
                        want.nundet, want.nconf, want.pair_counts):
                    raise AssertionError(f"{what}: nundet/nconf/pair counts differ")
                if mode == "quant":
                    for f, a, b in (("rcount_u", 0, 0), ("rcount_d", 1, 1)):
                        if not np.array_equal(entry_rows(imported[a], getattr(got, f)),
                                              entry_rows(orig[b], getattr(want, f))):
                            raise AssertionError(f"{what}: {f} by entry key differs")
        # one batch on the imported pair through the plain versions (cpu)
        n1 = int(reads.lengths[:BATCH].sum())
        one = ReadSet(codes=reads.codes[:BATCH], lengths=reads.lengths[:BATCH],
                      total_len=n1, name="one batch")
        for e in ENGINES:
            got = sessions[e, "imported"].run(one)
            want = QuerySession(*imported, G, cfg, device="cpu", engine=e).run(one)
            for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
                if not np.array_equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"imported pair, {e}: one batch, kernels vs "
                                         f"plain versions: {f} differs")
            if (got.nundet, got.nconf) != (want.nundet, want.nconf):
                raise AssertionError(f"imported pair, {e}: one batch, kernels vs "
                                     f"plain versions: nundet/nconf differ")
        q = counts[("sortjoin", "imported"), "quant"]
        sc = counts[("sortjoin", "imported"), "sc"]
        out["reference"] = {
            "genomes": DIST_GENOMES, "entries": entries, "bytes": nbytes,
            "write_s": write_s, "read_s": read_s, "build_s": build_s,
            "reads": reads.num_reads, "launches": launches,
            "assigned": int(q.cnts_u.sum() + q.cnts_d.sum()),
            "nundet": q.nundet, "nconf": q.nconf, "pairs_hit": len(sc.pair_counts)}
        log(f"{reads.num_reads} reads on the imported and the original pair, both "
            f"engines, quant and sc mode: counts, pair counts and rcounts by entry "
            f"key equal ({out['reference']['assigned']} assigned, {q.nundet} "
            f"undetermined, {q.nconf} conflicts, {len(sc.pair_counts)} pairs hit); "
            f"one batch through the plain versions (cpu) equal; launches {launches}")

    def formats_toy_pairs(self):
        """(b) Phase 10's toy with pairs through the reference format: its
        Type-II query on the card gives the original's pair counts and
        ident file."""
        import numpy as np

        from cammiq_tpu_torch import cli
        from cammiq_tpu_torch.config import QueryConfig
        from cammiq_tpu_torch.index.refcompat import (reference_index_to_flat,
                                                      write_reference_index)
        from cammiq_tpu_torch.index.table import load_flat_index_pair, save_flat_index
        from cammiq_tpu_torch.io.fastq import read_fastq
        from cammiq_tpu_torch.query.pipeline import QuerySession

        tp = self.toy_pairs
        if tp is None:
            raise RuntimeError("phase 10 kept no toy index")
        try:
            d = os.path.join(tp["root"], "refcompat")
            os.makedirs(d)
            imported = []
            for ix, name, npz in zip(load_flat_index_pair(tp["iu"], tp["idd"]),
                                     ("index.bin1", "index.bin2"),
                                     ("index_u.npz", "index_d.npz")):
                write_reference_index(os.path.join(d, name), ix)
                back = reference_index_to_flat(os.path.join(d, name), Lmax=40)
                if not np.array_equal(entry_rows(back), entry_rows(ix)):
                    raise AssertionError(f"toy {name}: entries differ")
                save_flat_index(os.path.join(d, npz), back)
                imported.append(back)
            for f in META_FILES:
                shutil.copy(os.path.join(os.path.dirname(tp["iu"]), f), d)
            pc = QuerySession(*imported, 6, QueryConfig(h=20), device=DEV).run(
                read_fastq(tp["fq"]), sc_mode=True).pair_counts
            if pc != tp["pair_counts"] or not pc:
                raise AssertionError(f"toy pair counts {pc} != {tp['pair_counts']}")
            out = os.path.join(tp["root"], "t2_imported.out")
            cli.main(["--device", DEV, "--query", "--read_cnts", "--doubly_unique",
                      "-f", tp["mapf"], "-i", os.path.join(d, "index_u.npz"),
                      os.path.join(d, "index_d.npz"), "-q", tp["fq"], "-e", "0.01",
                      "-o", out])
            with open(out) as f:
                t2 = f.read()
            if t2 != tp["type2"]:
                raise AssertionError("toy Type-II file differs on the imported index")
            self.results.setdefault("index_formats", {})["toy_pairs"] = {
                "entries": [ix.num_entries for ix in imported],
                "pair_counts": {f"{a},{b}": c for (a, b), c in pc.items()}}
            log(f"toy with pairs through the reference format (entries "
                f"{[ix.num_entries for ix in imported]}): pair counts {pc} and the "
                f"Type-II file equal the original index's")
        finally:
            shutil.rmtree(tp["root"], ignore_errors=True)
            self.toy_pairs = None

    def formats_pre_cuckoo(self, mdir, reads):
        """(c) A copy of phase 2's artifact as one saved before the cuckoo
        table: the session start that builds it in memory, ensure_cuckoo,
        and the session start after the upgrade."""
        import numpy as np
        import torch

        from cammiq_tpu_torch.config import QueryConfig
        from cammiq_tpu_torch.index.artifact import ensure_cuckoo, load_merged_artifact
        from cammiq_tpu_torch.query.pipeline import QuerySession

        want = self.quant_counts
        if want is None:
            raise RuntimeError("phase 5 left no counts to compare with")
        G = self.results["genomes"] + 1
        pre = os.path.join(REPO, "bench_cache", "smoke_pre_cuckoo")
        shutil.rmtree(pre, ignore_errors=True)
        os.makedirs(pre)
        # phase 2's arrays by symlink (ensure_cuckoo writes only cuckoo.npy,
        # absent here, and this copy's meta.json)
        for fn in os.listdir(mdir):
            if fn not in ("cuckoo.npy", "meta.json"):
                os.symlink(os.path.join(mdir, fn), os.path.join(pre, fn))
        with open(os.path.join(mdir, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(pre, "meta.json"), "w") as f:
            json.dump(dict(meta, cuckoo_log=0), f, indent=1)

        def start():
            torch.cuda.synchronize()
            t = time.time()
            art = load_merged_artifact(pre)
            sess = QuerySession.from_artifact(
                art, G, QueryConfig(h=art.h, erate=0.01, batch_size=BATCH), device=DEV)
            torch.cuda.synchronize()
            return art, sess, time.time() - t

        def check(sess, what):
            got = sess.run(reads)
            for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
                if not np.array_equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"{what}: {f} differs from phase 5")
            if (got.nundet, got.nconf) != (want.nundet, want.nconf):
                raise AssertionError(f"{what}: nundet/nconf differ from phase 5")

        try:
            art, sess, before_s = start()
            if art.cuckoo is not None:
                raise AssertionError("the pre-cuckoo copy has a cuckoo table")
            check(sess, "pre-cuckoo session")
            del art, sess
            torch.cuda.empty_cache()
            err = Tee(sys.stderr)
            t = time.time()
            with contextlib.redirect_stderr(err):
                first = ensure_cuckoo(pre, verbose=True)
            ensure_s = time.time() - t
            second = ensure_cuckoo(pre)
            if (first, second) != (True, False):
                raise AssertionError(f"ensure_cuckoo returned {first}, then {second}")
            a = np.load(os.path.join(pre, "cuckoo.npy"), mmap_mode="r")
            b = np.load(os.path.join(mdir, "cuckoo.npy"), mmap_mode="r")
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError("ensure_cuckoo's table differs from phase 2's")
            rows = int(a.shape[0])
            del a, b
            with open(os.path.join(pre, "meta.json")) as f1, \
                    open(os.path.join(mdir, "meta.json")) as f2:
                if f1.read() != f2.read():
                    raise AssertionError("ensure_cuckoo's meta.json differs from phase 2's")
            art, sess, after_s = start()
            if art.cuckoo is None:
                raise AssertionError("the upgraded copy has no cuckoo table")
            check(sess, "upgraded session")
            del art, sess
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(pre, ignore_errors=True)
        self.results.setdefault("index_formats", {})["pre_cuckoo"] = {
            "session_start_before_s": before_s, "ensure_cuckoo_s": ensure_s,
            "session_start_after_s": after_s, "cuckoo_rows": rows,
            "phase5_session_start_s": self.results.get("session_start_s")}
        log(f"pre-cuckoo artifact at config #3 (host {cpu_model()}): session start "
            f"{before_s:.3f} s (cuckoo table built in memory), ensure_cuckoo "
            f"{ensure_s:.3f} s ({rows} rows, equal to phase 2's, meta.json "
            f"equal; True then False), session start after the upgrade "
            f"{after_s:.3f} s (phase 5: {self.results.get('session_start_s', 0):.3f} "
            f"s); both sessions' quant pass equals phase 5's counts")

    def start_artifact_command(self, mdir):
        """Start (d)'s child process, ``python -m
        cammiq_tpu_torch.index.artifact`` on phase 2's npz pair, so that its
        host work overlaps phase 12's device work; ``formats_command``
        waits for it and checks its output."""
        cdir = os.path.dirname(mdir)
        out = os.path.join(REPO, "bench_cache", "smoke_artifact_cmd")
        shutil.rmtree(out, ignore_errors=True)
        err = open(out + ".err", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cammiq_tpu_torch.index.artifact", "-i",
             os.path.join(cdir, "index_u.npz"), os.path.join(cdir, "index_d.npz"),
             "-o", out],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.DEVNULL, stderr=err)
        self.artifact_cmd = (proc, err, out, time.time())

    def stop_artifact_command(self):
        """Kill (d)'s child process if it still runs; remove its output."""
        if self.artifact_cmd is None:
            return
        proc, err, out, _ = self.artifact_cmd
        self.artifact_cmd = None
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        err.close()
        shutil.rmtree(out, ignore_errors=True)
        os.remove(out + ".err")

    def formats_command(self, mdir):
        """(d) ``python -m cammiq_tpu_torch.index.artifact`` on phase 2's
        npz pair (started before phase 12) writes phase 2's artifact."""
        import numpy as np

        if self.artifact_cmd is None:
            raise RuntimeError("the artifact command was not started")
        proc, err, out, t0 = self.artifact_cmd
        try:
            t = time.time()
            rc = proc.wait(timeout=600)
            waited_s, cmd_s = time.time() - t, time.time() - t0
            err.seek(0)
            stderr = err.read()
            if rc:
                raise RuntimeError(f"artifact command failed: {stderr[-3000:]}")
            names = sorted(os.listdir(mdir))
            if sorted(os.listdir(out)) != names:
                raise AssertionError(f"artifact command files {sorted(os.listdir(out))} "
                                     f"!= {names}")
            for fn in names:
                a, b = os.path.join(out, fn), os.path.join(mdir, fn)
                if fn.endswith(".npy"):
                    x, y = np.load(a, mmap_mode="r"), np.load(b, mmap_mode="r")
                    same = x.dtype == y.dtype and np.array_equal(x, y)
                else:
                    with open(a, "rb") as f1, open(b, "rb") as f2:
                        same = f1.read() == f2.read()
                if not same:
                    raise AssertionError(f"artifact command: {fn} differs from phase 2's")
        finally:
            self.stop_artifact_command()
        self.results.setdefault("index_formats", {})["command"] = {
            "wall_s": cmd_s, "waited_s": waited_s, "stderr": stderr.strip()}
        log(f"python -m cammiq_tpu_torch.index.artifact on phase 2's npz pair "
            f"(started before phase 12, ran beside it): exited within {cmd_s:.1f} s of "
            f"its start, {waited_s:.1f} s of it waited for here; every file equal "
            f"to phase 2's ({len(names)} files); {stderr.strip().splitlines()[-1]}")

    # ---- 15. quant at scale: the mixture's solves on config #3
    def quant_scale(self, art, sess):
        """realized_free.py's mixture (MIX_PRESENT genomes in lognormal
        abundance, MIX_BATCHES batches) through the session (set-up), its
        problems under three fine settings, and solve_quant on the card for
        the stress and the constrained one: the solves are this path
        (counters zeroed before, read after).  Then the kernel against its
        plain version on chunks captured from them, and whole solves
        against the plain version's."""
        import numpy as np
        import torch

        import cammiq_tpu_torch.models.quant as mq
        from cammiq_tpu_torch.config import FineParams
        from cammiq_tpu_torch.io.fastq import ReadSet
        from cammiq_tpu_torch.io.mapfile import (Genome, GenomeTable,
                                                 load_genome_lengths)
        from cammiq_tpu_torch.kernels import quant_fista as kqf
        from cammiq_tpu_torch.tools.benchdata import gen_genomes, sample_mixture

        out = self.results["quant_scale"] = {}
        G = self.results["genomes"] + 1
        t = time.time()
        genomes = gen_genomes(self.results["genomes"], self.results["genome_len"])
        present, weights, batches = sample_mixture(genomes, MIX_PRESENT, MIX_BATCHES)
        del genomes
        codes = np.concatenate([b[0] for b in batches])
        lengths = np.concatenate([b[1] for b in batches])
        reads = ReadSet(codes=codes, lengths=lengths,
                        total_len=int(lengths.sum()), name="mixture")
        counts = sess.run(reads)
        table = GenomeTable([None] + [Genome(taxid=i, name=f"g{i}")
                                      for i in range(1, G)])
        load_genome_lengths(table, art.path)
        gl, nus, nds = table.arrays()
        index_u, index_d = art.payloads()
        probs = {}
        for variant, kw in MIX_FINE.items():
            p = mq.build_problem(
                index_u, index_d, counts.rcount_u, counts.rcount_d,
                counts.cnts_u.astype(np.float64), counts.cnts_d.astype(np.float64),
                nus.astype(np.float64), nds.astype(np.float64), gl,
                counts.mean_read_len, counts.num_reads, 0.01, FineParams(**kw))
            forced = p.exist0 & (p.lb > 0)
            out[variant] = {"candidates": int(p.exist0.sum()),
                            "free": int((p.exist0 & ~forced).sum()),
                            "c2_rows": len(p.c2_species), "n": p.n,
                            "terms_u": len(p.ug), "terms_d": len(p.dg1)}
            probs[variant] = p
            log(f"quant at scale, {variant} fine parameters {kw}: {out[variant]}")
        log(f"set-up {time.time() - t:.1f} s: {reads.num_reads} reads of "
            f"{MIX_PRESENT} present genomes ({MIX_BATCHES} x {BATCH}), "
            f"{int(counts.cnts_u.sum())} unique-assigned; abundance weights "
            f"{np.round(np.sort(weights)[::-1], 4).tolist()}")
        for variant, need in (("stress", MIX_STRESS_FREE), ("constrained", 1)):
            if out[variant]["free" if variant == "stress" else "c2_rows"] < need:
                log(f"quant at scale: the {variant} problem realizes "
                    f"{out[variant]} (fewer than {need}): solved as it is")

        # the path: both solves on the card, every chunk one launch
        captured = {}
        orig = mq.fista_chunk

        def recorder(x0, lam, lbv, ubv, n_it, p, step, rho):
            S = max(x0.shape[0] if x0.dim() == 2 else 1,
                    lbv.shape[0] if lbv.dim() == 2 else 1)
            args = (x0.clone(), lam.clone(), lbv.clone(), ubv.clone(), n_it, p,
                    step, rho)
            calls["batch" if S > 1 else "one"] += 1
            key = "enum" if S > 1 else "stage1" if not captured else "last"
            if key != "enum" or "enum" not in captured:
                captured[key] = args
            return orig(x0, lam, lbv, ubv, n_it, p, step, rho)

        solved = {}
        zero_counts()
        torch.cuda.synchronize()
        for variant in ("stress", "constrained"):
            captured.clear()
            calls = {"one": 0, "batch": 0}
            mq.fista_chunk = recorder
            try:
                before = kqf.KERNEL.launches
                exist, cov, info = mq.solve_quant(probs[variant], device=sess.device)
                launched = kqf.KERNEL.launches - before
            finally:
                mq.fista_chunk = orig
            solved[variant] = (exist, cov, info, dict(captured), dict(calls))
            if launched != info.get("fista_chunks"):
                raise AssertionError(f"{variant}: {launched} launches for "
                                     f"{info.get('fista_chunks')} chunks")
            nodes = info.get("bnb_nodes", 0)
            out[variant].update(
                solve_s=info["solve_time"], stage_s=info.get("stage_s"),
                stage1_chunks=info.get("chunks_used"),
                enum_rounds=info.get("enum_rounds"), bnb_nodes=nodes,
                stopped_by=info.get("stopped_by"), launches=launched,
                selected=int(exist.sum()),
                bound_s_per_node=info["bound_s"] / nodes if nodes else None)
            log(f"quant at scale, {variant} on the card: {launched} launches of "
                f"quant_fista = {launched} chunks (stage 1: {info.get('chunks_used')}, "
                f"{info.get('enum_rounds')} enumeration rounds of "
                f"{info.get('enum_size')} subsets, {nodes} B&B nodes), stopped by "
                f"{info.get('stopped_by')}, {int(exist.sum())} selected; solve "
                f"{info['solve_time']:.3f} s by stage "
                f"{ {k: round(v, 4) for k, v in info['stage_s'].items()} }, host "
                f"bound {out[variant]['bound_s_per_node']} s a node")
            if not (np.isfinite(cov).all() and cov.shape == (G,)
                    and exist[probs[variant].exist0].any()
                    and not exist[~probs[variant].exist0].any()):
                raise AssertionError(f"{variant}: implausible solve output")
        read_counts("quant_scale", self.results)

        # the kernel against its plain version on captured chunks
        stress_info = solved["stress"][2]
        chunks = {"quant_fista": solved["stress"][3]["stage1"],
                  "quant_fista@enum": solved["stress"][3].get("enum"),
                  "quant_fista@bnb": (solved["stress"][3].get("last")
                                      if stress_info.get("bnb_nodes") else None)}
        for name, args in chunks.items():
            if args is None:
                log(f"{name}: the stress solve ran no such chunk")
                continue
            self.quant_fista_vs_plain(name, args)

        # whole solves: the kernel's against the plain version's
        def plain_chunk(x0, lam, lbv, ubv, n_it, p, step, rho):
            return kqf.fista_chunk_plain(x0, lam, lbv, ubv, n_it, p, step, rho)

        for variant in ("constrained", "stress"):
            exist, cov, info, _, calls = solved[variant]
            if variant == "stress":
                per = {k: self.kernels[k]["plain_ms"] / 1e3 for k in chunks
                       if k in self.kernels}
                est = (calls["one"] * per.get("quant_fista", 0.0)
                       + calls["batch"] * per.get("quant_fista@enum", 0.0))
                out["stress"]["plain_estimate_s"] = est
                if est > MIX_PLAIN_LIMIT_S:
                    log(f"quant at scale, stress: the plain solve would take about "
                        f"{est:.0f} s (> {MIX_PLAIN_LIMIT_S} s): compared at the "
                        f"chunk level only")
                    continue
            mq.fista_chunk = plain_chunk
            try:
                pe, pc, pi = mq.solve_quant(probs[variant], device=sess.device)
            finally:
                mq.fista_chunk = orig
            l1 = float(np.abs(cov / cov[exist].sum() - pc / pc[pe].sum()).sum())
            out[variant].update(plain_solve_s=pi["solve_time"],
                                plain_stage_s=pi.get("stage_s"), abundance_l1=l1)
            log(f"quant at scale, {variant}: plain solve {pi['solve_time']:.3f} s "
                f"by stage { {k: round(v, 4) for k, v in pi['stage_s'].items()} } "
                f"against the kernel's {info['solve_time']:.3f} s; same EXIST "
                f"{bool((pe == exist).all())}, abundance L1 {l1:.3g}, stopped by "
                f"{pi['stopped_by']} / {info['stopped_by']}")
            if not ((pe == exist).all() and l1 <= 1e-3
                    and pi["stopped_by"] == info["stopped_by"]):
                raise AssertionError(f"{variant}: kernel solve != plain solve")

    def quant_fista_vs_plain(self, name, args):
        """quant_fista against its plain version on one captured chunk: max
        |x - x_plain| within QUANT_CHUNK_TOL x max(1, max |x_plain|), timed
        beside its bound."""
        import torch

        from cammiq_tpu_torch.kernels import quant_fista as kqf

        x0, lam, lbv, ubv, n_it, p, step, rho = args
        S = max(x0.shape[0] if x0.dim() == 2 else 1,
                lbv.shape[0] if lbv.dim() == 2 else 1)
        stats = torch.zeros(S, 2, dtype=torch.int32, device=x0.device)
        got = kqf.fista_chunk(*args, stats=stats)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        want = kqf.fista_chunk_plain(*args)
        e.record()
        torch.cuda.synchronize()
        plain_ms = s.elapsed_time(e)
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        ms = cuda_median_ms(lambda: kqf.fista_chunk(*args), 5, 3, 1)
        dev_ms = device_ms(lambda: kqf.fista_chunk(*args), 3)
        bnd = bound_quant_fista(p, S, n_it, stats)
        dev = (f"{dev_ms:.4f} ms" if dev_ms else
               "not measured: the host outran the sleep")
        log(f"{name}: S={S} n={p.n} C2={p.C2} n_it={n_it} nnz(H, M, R)="
            f"{[p.folded[k].numel() for k in ('h_val', 'm_val', 'r_val')]} "
            f"coordinates with lb < ub {stats[:, 1].tolist()[:4]}, grid "
            f"projections {stats[:, 0].sum().item()}; max_abs_err={err:.3g} "
            f"(scale {scale:.3g}) kernel {ms:.4f} ms (device only {dev}) plain "
            f"{plain_ms:.4f} ms bound {bnd['bound_ms']:.6f} ms ({bnd['bound_by']}: "
            f"{bnd['bytes']} B, {bnd['ops']} ops) -> "
            f"{100 * bnd['bound_ms'] / ms:.4f}% of bound")
        self.kernels[name] = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                              "plain_ms": plain_ms, "S": S, "n": p.n, "C2": p.C2,
                              "n_it": n_it, "scale": scale, **bnd}
        if not err <= QUANT_CHUNK_TOL * scale:
            raise AssertionError(f"{name}: kernel != plain version ({err})")

    def report(self, device_name: str, smi: str):
        import torch

        kernels = []
        launches = self.results.get("launches", {})
        for name, (src, replaces, path, *stats) in KERNEL_INFO.items():
            k = self.kernels.get(stats[0] if stats else name, {})
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": launches.get(path, {}).get(
                                name.split("@")[0], 0),
                            "max_abs_err": k.get("max_abs_err"),
                            "ms": k.get("ms"), "device_ms": k.get("device_ms"),
                            "plain_ms": k.get("plain_ms"),
                            "bound_ms": k.get("bound_ms"),
                            "bound_by": k.get("bound_by"),
                            # no single PyTorch call computes any of these
                            "library_ms": None})
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump({"device": device_name, "nvidia_smi": smi,
                       "results": self.results, "kernels": self.kernels,
                       "failed": self.failed}, f, indent=1, default=str)
        log(smi)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": device_name,
            "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import cammiq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {device_name} ({smi})")
    s = Smoke()
    s.phase("header + kernel and native builds", s.header)
    if s.failed:
        return 1
    mdir = s.phase("config-#3 index, device build (set-up)", s.realistic_index)
    reads = s.phase("reads", s.reads)
    art_sess = s.phase("session", s.session, mdir) if mdir and reads else None
    if art_sess:
        art, sess = art_sess
        s.phase("kernels vs plain versions", s.kernels_vs_plain, sess, reads)
        s.phase("probe_bloom in two levels at the benchmark's batch",
                s.probe_levels, sess, reads)
    if reads:
        s.phase("the upload at 2 bits a base vs plain", s.upload_vs_plain, reads)
    s.phase("toy end to end through the CLI", s.toy_cli)
    if art_sess:
        s.phase("main path at config-#3 scale", s.main_path, art, sess, reads)
        if "main path at config-#3 scale" not in s.failed:
            s.phase("Type-II at config-#3 scale", s.type2_main, art, sess, reads)
        if "Type-II at config-#3 scale" not in s.failed:
            s.phase("distributed query: NCCL grid and two shards", s.grid, art,
                    sess, reads)
            s.phase("gather engine at config-#3 scale", s.gather_engine, mdir,
                    sess, reads)
        s.phase("quant at scale: the mixture's solves", s.quant_scale, art, sess)
        del art, sess, art_sess
        torch.cuda.empty_cache()
    s.phase("toy Type-II and build through the CLI", s.toy_type2)
    s.phase("device build vs CPU build", s.build_vs_cpu)
    if "device build vs CPU build" in s.failed:
        s.failed.append("host build engines vs the device build (not run)")
    else:
        s.phase("host build engines vs the device build", s.host_engines)
        s.build_check = None
    if mdir:
        s.phase("index formats on the card (d): the artifact command, started",
                s.start_artifact_command, mdir)
    try:
        s.phase("build kernels vs plain versions", s.build_kernels)
        # ---- 14. index formats on the card
        s.phase("index formats on the card (a): a reference-format index",
                s.formats_reference)
        s.phase("index formats on the card (b): the toy with pairs",
                s.formats_toy_pairs)
        # (d) ends before (c), whose session starts and cuckoo build it
        # would otherwise share the host with
        if mdir:
            s.phase("index formats on the card (d): the artifact command",
                    s.formats_command, mdir)
        if mdir and reads:
            s.phase("index formats on the card (c): a pre-cuckoo artifact",
                    s.formats_pre_cuckoo, mdir, reads)
    finally:
        s.stop_artifact_command()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "cammiq_tpu", "bench", "benchmarks"))
    if leaked:
        s.failed.append(f"imported {leaked}")
    if s.failed or not mdir:
        log(f"FAILED phases: {s.failed}")
        return 1
    s.report(device_name, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
