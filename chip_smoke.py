#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cammiq_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (written for an H100), the CUDA toolkit (nvcc) and a
C++ compiler with OpenMP.  It builds everything from this checkout, imports
nothing of JAX or of the JAX package, and exits nonzero if any phase fails:

1. header: the card's name and power limit, torch/CUDA/nvcc versions; the
   five CUDA kernels and the native host library are compiled (build
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
   reads x 100 bases; the scan also at n = 2^20), exact equality required,
   median CUDA-event times of both beside the kernel's bound;
4. toy end to end through the CLI (5 x 2000 bp genomes, 4000 simulated
   reads, index built on cuda): quant abundances within 0.01 of the truth
   for all 5 genomes, a Type-I file identical to the one the CPU path
   writes;
5. main path at config-#3 scale: QuerySession.from_artifact on cuda over 16
   batches of 8192 reads, then build_problem + solve_quant; the kernels'
   launch counters are zeroed just before and read just after, and every
   kernel must have launched; one batch must give identical counts through
   the kernels (cuda) and the plain versions (cpu).  Steady-state reads/s,
   session start and peak device memory are printed;
6. Type-II at config-#3 scale: the same reads in sc mode (launch counters
   zeroed before, read after); cnts_u/cnts_d/nundet/nconf must equal the
   quant pass, the pair counts go to solve_ident, steady-state sc and quant
   passes are timed in turns, and one batch's outputs, pair outputs
   included, must be identical through the kernels (cuda) and the plain
   versions (cpu);
7. profile: one more quant pass under torch.profiler, device time by
   kernel and the device's busy share of the pass's wall time (the table
   also goes to chiprun_out/chip_smoke_profile.txt);
8. toy Type-II through the CLI: 5 genomes x 2000 bp with a 300 bp segment
   planted in each pair of neighbours, indexed by `--build --device cuda`
   and by `--build --device cpu` (files must be equal), then a Type-II file
   from `--device cuda` identical to the one from `--device cpu`, with
   nonzero pair counts;
9. the device build on cuda against the same build on the CPU device (the
   plain versions of every kernel), array for array, on the bench generator
   at BUILD_CHECK_GENOMES genomes (chosen so the CPU build takes about two
   minutes); stage seconds of both are printed;
10. build kernels against their plain versions on the config-#3 build's own
   tensors (recomputed from the corpus): first_of_run at the build's n in
   full, in index and value mode, forward and reverse; lcp_pairs and
   occ_count (unique and doubly) timed at full n (lcp_pairs also with
   clamp 32, its thread phase alone), and, with their plain
   versions, on a contiguous slice of 2^24 ranks around the longest LCP
   (the plain versions loop in Python over live sets, too slow for 6e8
   ranks within the time limit); exact equality required.

Every kernel time is printed beside its bound: the least time the card
could take for the call, the larger of its bytes (each input read once,
each output written once, counting what this call's data needs) over
HBM_BYTES_PER_S and its operations over SCALAR_OPS_PER_S.

Before the last line it prints the nvidia-smi line and one JSON object
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Numbers and logs also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
BATCH = 8192
N_BATCHES = 16
SCAN_N = 1 << 20
TOY_TOL = 0.01
BUILD_CHECK_GENOMES = 64
SLICE = 1 << 24
DEV = "cuda"
# H100 SXM datasheet peaks: HBM3 bandwidth, and the
# float32 rate outside the tensor cores, taken as the peak of the scalar
# integer work these kernels do (the larger rate gives the smaller bound)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# name -> (source, what it replaces, the path whose launches it reports)
KERNEL_INFO = {
    "first_of_run": ("cammiq_tpu_torch/csrc/first_of_run.cu",
                     "benchmarks/pallas_repro.py:79", "quant"),
    "probe_bloom": ("cammiq_tpu_torch/csrc/probe_bloom.cu",
                    "cammiq_tpu/query/sortjoin.py:867", "quant"),
    "cuckoo_verify": ("cammiq_tpu_torch/csrc/cuckoo_verify.cu",
                      "cammiq_tpu/query/sortjoin.py:1142", "quant"),
    "lcp_pairs": ("cammiq_tpu_torch/csrc/lcp_pairs.cu",
                  "cammiq_tpu/ops/lcp.py:90", "build"),
    "occ_count": ("cammiq_tpu_torch/csrc/occ_count.cu",
                  "cammiq_tpu/index/unique_jax.py:132", "build"),
}
# the kernels each driven path must launch
PATH_KERNELS = {
    "quant": ("first_of_run", "probe_bloom", "cuckoo_verify"),
    "typeII": ("first_of_run", "probe_bloom", "cuckoo_verify"),
    "build": ("first_of_run", "lcp_pairs", "occ_count"),
}
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


def bound_probe_bloom(codes, bloom, h, blog, khlo) -> dict:
    """The codes, the bloom words this batch touches, both outputs."""
    import torch

    from cammiq_tpu_torch import u32

    words = torch.unique(u32.widen(khlo) >> (32 - blog)).numel()
    return bound(codes.numel() + 4 * words + 5 * khlo.numel())


def bound_cuckoo_verify(args, found, h) -> dict:
    """The rows and their hashes, the codes and lengths of the reads they
    fall in, the cuckoo rows they hash to, the entries they match (a lower
    bound: the bucket scan reads every entry of the span), the output."""
    import torch

    from cammiq_tpu_torch import u32
    from cammiq_tpu_torch.kernels.cuckoo_verify import cuckoo_pos
    from cammiq_tpu_torch.kernels.probe_bloom import num_offsets

    rows, khlo, codes, lengths, cuckoo, clog, erec, _ = args
    K = rows.numel()
    Lp = codes.shape[1]
    reads = torch.unique(rows // num_offsets(Lp, h)).numel()
    key = u32.widen(khlo[rows])
    crows = torch.unique(torch.cat([cuckoo_pos(key, 0, clog),
                                    cuckoo_pos(key, 1, clog)])).numel()
    ents = torch.unique(found[found >= 0]).numel()
    return bound(12 * K + reads * (Lp + 4) + crows * cuckoo.shape[1] * 4
                 + ents * erec.shape[1] * 4 + 4 * found.numel())


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


def kernel_counters() -> dict:
    from cammiq_tpu_torch.kernels import (cuckoo_verify, first_of_run,
                                          lcp_pairs, occ_count, probe_bloom)

    return {"first_of_run": first_of_run.KERNEL,
            "probe_bloom": probe_bloom.KERNEL,
            "cuckoo_verify": cuckoo_verify.KERNEL,
            "lcp_pairs": lcp_pairs.KERNEL, "occ_count": occ_count.KERNEL}


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


def max_abs_err(a, b) -> int:
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


def stage_table(stages: dict, peaks: dict, other: dict | None = None) -> str:
    return "\n".join(
        f"  {k:<48} {v:9.3f} s" + (f"   cpu {other.get(k, float('nan')):9.3f} s"
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
                plain_reps=(11, 20, 3), **kw):
        """Kernel against its plain version on the same CUDA tensors:
        exact equality, median CUDA-event times, the bound beside them."""
        import torch

        got = kern(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        ms = cuda_median_ms(lambda: kern(*args, **kw), *reps)
        plain_ms = cuda_median_ms(lambda: plain(*args, **kw), *plain_reps)
        shape = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        log(f"{name}: shapes {shape} equal={same} max_abs_err={err} kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}: {bnd['bytes']} B, {bnd['ops']} ops) -> "
            f"{100 * bnd['bound_ms'] / ms:.1f}% of bound")
        self.kernels[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "shapes": shape, **bnd}
        if not same:
            raise AssertionError(f"{name}: kernel != plain version")
        return got

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
        import numpy as np

        from cammiq_tpu_torch.io.fastq import ReadSet
        from cammiq_tpu_torch.tools.benchdata import (BENCH_GENOMES, BENCH_GLEN,
                                                      gen_genomes, sample_read_batch)

        genomes = gen_genomes(BENCH_GENOMES, BENCH_GLEN)
        rng = np.random.default_rng(1)
        parts = [sample_read_batch(rng, genomes, BATCH) for _ in range(N_BATCHES)]
        codes = np.concatenate([p[0] for p in parts])
        lengths = np.concatenate([p[1] for p in parts])
        return ReadSet(codes=codes, lengths=lengths,
                       total_len=int(lengths.sum()), name="bench")

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
            for t in (sess.dm.bloom, sess.dm.cuckoo, sess.dm.erec, sess.dm.prec))
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
        # record each wrapper's arguments and result during one real batch
        captured = {}
        originals = {}
        for name in ("probe_bloom", "cuckoo_verify", "first_of_run_scan"):
            orig = getattr(sj, name)
            originals[name] = orig

            def rec(*a, _n=name, _f=orig):
                out = _f(*a)
                captured[_n] = (a, out)
                return out

            setattr(sj, name, rec)
        try:
            sj.classify_batch(sess.dm, codes, lengths, sess.num_genome_slots,
                              sess.maxm)
        finally:
            for name, orig in originals.items():
                setattr(sj, name, orig)
        rng = np.random.default_rng(3)
        scan_big = (torch.from_numpy(rng.random(SCAN_N) < 0.05).to(dev),
                    torch.from_numpy(rng.integers(0, 1 << 30, SCAN_N)
                                     .astype(np.int32)).to(dev))
        pb_args, (_, khlo) = captured["probe_bloom"]
        cv_args, found = captured["cuckoo_verify"]
        fr_args, _ = captured["first_of_run_scan"]
        h = sess.dm.h
        self.compare("probe_bloom", kpb.probe_bloom, kpb.probe_bloom_plain,
                     pb_args, bound_probe_bloom(*pb_args, khlo))
        self.compare("cuckoo_verify", kcv.cuckoo_verify, kcv.cuckoo_verify_plain,
                     cv_args, bound_cuckoo_verify(cv_args, found, h))
        self.compare("first_of_run", kfr.first_of_run_scan,
                     kfr.first_of_run_scan_plain, fr_args,
                     bound_first_of_run(*fr_args))
        self.compare("first_of_run@2^20", kfr.first_of_run_scan,
                     kfr.first_of_run_scan_plain, scan_big,
                     bound_first_of_run(*scan_big))

    # ---- 4. toy end to end through the CLI
    def toy_cli(self):
        import numpy as np

        from cammiq_tpu_torch import cli
        from cammiq_tpu_torch.kernels import cuckoo_verify, first_of_run, probe_bloom
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
            kerns = (probe_bloom.KERNEL, cuckoo_verify.KERNEL, first_of_run.KERNEL)
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
            f"{sess.maxm}, launches {launches}")
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
        # steady state: the same pass again (maxm settled, kernels warm)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.time()
            c2 = sess.run(reads)
            runs.append(time.time() - t)
            for f in ("cnts_u", "cnts_d", "rcount_u", "rcount_d"):
                if not np.array_equal(getattr(c2, f), getattr(counts, f)):
                    raise AssertionError(f"repeat pass differs in {f}")
        best = min(runs)
        self.results["pass_s"] = runs
        self.results["reads_per_s"] = reads.num_reads / statistics.median(runs)
        self.results["batch_ms"] = statistics.median(runs) / N_BATCHES * 1e3
        self.results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        self.results["solve_s"] = info["solve_time"]
        self.results["quant_candidates"] = int(prob.exist0.sum())
        log(f"steady state: passes {['%.4f' % r for r in runs]} s -> "
            f"{self.results['reads_per_s']:.1f} reads/s (median; best "
            f"{reads.num_reads / best:.1f}), {self.results['batch_ms']:.3f} "
            f"ms/batch; max_memory_allocated "
            f"{self.results['max_memory_allocated'] / 1e9:.3f} GB")
        # one batch through the kernels (cuda) vs the plain versions (cpu)
        dm_cpu = TorchMergedIndex.from_artifact(art, "cpu")
        codes = reads.codes[:BATCH]
        lengths = reads.lengths[:BATCH]
        outs = []
        for dm in (sess.dm, dm_cpu):
            rc = torch.zeros(art.eu + art.ed + 1, dtype=torch.int32, device=dm.device)
            bc = classify_batch(dm, torch.from_numpy(codes).to(dm.device),
                                torch.from_numpy(lengths).to(dm.device), G,
                                sess.maxm, rc)
            outs.append([x.cpu() for x in (*bc, rc)])
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        log(f"one batch, kernels vs plain versions: identical={same}")
        if not same:
            raise AssertionError("kernel path and plain path counts differ")

    # ---- 7. where a steady-state pass spends device time
    def profile(self, sess, reads):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        sess.run(reads)                                   # warm, maxm settled
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.time()
            sess.run(reads)
            torch.cuda.synchronize()
            wall_us = (time.time() - t) * 1e6
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev.sort(key=lambda e: -e.self_device_time_total)
        busy_us = sum(e.self_device_time_total for e in dev)
        lines = [f"{e.self_device_time_total / 1e3:.3f} ms {e.count}x {e.key[:120]}"
                 for e in dev]
        self.results["profile_wall_ms"] = wall_us / 1e3
        self.results["profile_device_ms"] = busy_us / 1e3
        self.results["profile_top"] = lines[:12]
        with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        log(f"one pass under the profiler: wall {wall_us / 1e3:.3f} ms, device "
            f"busy {busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%); "
            f"device time by kernel:\n" + "\n".join(lines[:12]))

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
        # steady state: sc and quant passes in turns, so the two modes
        # are compared on the same host at the same time
        runs = {"sc": [], "quant": []}
        for mode in ("sc", "quant", "quant", "sc", "sc", "quant"):
            torch.cuda.synchronize()
            t = time.time()
            c2 = sess.run(reads, sc_mode=mode == "sc")
            runs[mode].append(time.time() - t)
            if mode == "sc" and c2.pair_counts != counts.pair_counts:
                raise AssertionError("repeat sc-mode pass differs in pair_counts")
        rate = {m: reads.num_reads / statistics.median(r) for m, r in runs.items()}
        self.results["typeII"] = {
            "pair_table": P, "pairs_hit": len(counts.pair_counts),
            "pair_assigned_reads": paired, "first_pass_s": pass_s,
            "pass_s": runs, "reads_per_s": rate["sc"],
            "quant_reads_per_s_interleaved": rate["quant"],
            "ident_s": ident_s, "ident_exist": int(np.sum(exist)),
            "launches": launches}
        log(f"Type-II pass: P={P} pairs in the table, {len(counts.pair_counts)} "
            f"hit, {paired} pair-assigned reads; first pass {pass_s:.3f} s; "
            f"in turns with quant: sc {['%.4f' % r for r in runs['sc']]} s -> "
            f"{rate['sc']:.1f} reads/s, quant {['%.4f' % r for r in runs['quant']]}"
            f" s -> {rate['quant']:.1f} reads/s; solve_ident {ident_s:.3f} s, "
            f"{int(np.sum(exist))} genomes; launches {launches}")
        # one batch through the kernels (cuda) vs the plain versions (cpu)
        dm_cpu = TorchMergedIndex.from_artifact(art, "cpu")
        outs = []
        for dm in (sess.dm, dm_cpu):
            bc = classify_batch(dm, torch.from_numpy(reads.codes[:BATCH]).to(dm.device),
                                torch.from_numpy(reads.lengths[:BATCH]).to(dm.device),
                                G, sess.maxm, sc_mode=True)
            outs.append([x.cpu() for x in bc])
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        npair = int((outs[0][5] >= 0).sum())
        log(f"one sc-mode batch, kernels vs plain versions: identical={same}, "
            f"{npair} pair-assigned reads")
        if not same:
            raise AssertionError("sc-mode batch outputs differ kernels vs plain")

    # ---- 8. toy Type-II and the build through the CLI, cuda against cpu
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
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # ---- 9. the device build against the CPU build at a reduced size
    def build_vs_cpu(self):
        import numpy as np

        from cammiq_tpu_torch.config import BuildConfig
        from cammiq_tpu_torch.index.builder import build_index, write_meta_outputs
        from cammiq_tpu_torch.io.fasta import corpus_from_sequences
        from cammiq_tpu_torch.tools.benchdata import BENCH_GLEN, gen_genomes

        corpus = corpus_from_sequences(gen_genomes(BUILD_CHECK_GENOMES, BENCH_GLEN))
        cfg = BuildConfig(k=26, L=100, Lmax=50, h=26, mode="both")
        arts, secs = {}, {}
        for dev in (DEV, "cpu"):
            t = time.time()
            with contextlib.redirect_stderr(io.StringIO()):
                arts[dev] = build_index(corpus, cfg, device=dev, verbose=True)
            secs[dev] = time.time() - t
        got, want = arts[DEV], arts["cpu"]
        for name in ("unique_index", "doubly_index"):
            assert_same_index(getattr(got, name), getattr(want, name),
                              f"build cuda vs cpu {name}")
        for f in ("ulm_count_u", "ulm_count_d", "genome_lengths"):
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"build cuda vs cpu: {f} differs")
        tmp = tempfile.mkdtemp(prefix="smoke_meta_", dir=OUT_DIR)
        try:
            for dev, art in arts.items():
                write_meta_outputs(art, os.path.join(tmp, dev))
            for f in META_FILES:
                with open(os.path.join(tmp, DEV, f)) as a, \
                        open(os.path.join(tmp, "cpu", f)) as b:
                    if a.read() != b.read():
                        raise AssertionError(f"build cuda vs cpu: {f} differs")
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        stages = {d: a.timings.as_dict() for d, a in arts.items()}
        self.results["build_vs_cpu"] = {
            "genomes": BUILD_CHECK_GENOMES, "n": corpus.n, "build_s": secs,
            "stages_s": stages,
            "entries": (got.unique_index.num_entries, got.doubly_index.num_entries)}
        log(f"build of n={corpus.n} ({BUILD_CHECK_GENOMES} genomes): cuda "
            f"{secs[DEV]:.1f} s, cpu {secs['cpu']:.1f} s; both tables "
            f"({got.unique_index.num_entries}, {got.doubly_index.num_entries} "
            f"entries), ulm counts and meta files identical; stages (cuda | cpu):\n"
            + stage_table(stages[DEV], {}, stages["cpu"]))

    # ---- 10. build kernels vs plain versions on the build's tensors
    def build_kernels(self):
        import numpy as np
        import torch

        from cammiq_tpu_torch.index import unique as uq
        from cammiq_tpu_torch.io.fasta import corpus_from_sequences
        from cammiq_tpu_torch.kernels import first_of_run as kfr
        from cammiq_tpu_torch.kernels import lcp_pairs as klcp
        from cammiq_tpu_torch.kernels import occ_count as kocc
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

    def report(self, device_name: str, smi: str):
        import torch

        kernels = []
        launches = self.results.get("launches", {})
        for name, (src, replaces, path) in KERNEL_INFO.items():
            k = self.kernels.get(name, {})
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": launches.get(path, {}).get(name, 0),
                            "max_abs_err": k.get("max_abs_err"),
                            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
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
    s.phase("toy end to end through the CLI", s.toy_cli)
    if art_sess:
        s.phase("main path at config-#3 scale", s.main_path, art, sess, reads)
        if "main path at config-#3 scale" not in s.failed:
            s.phase("Type-II at config-#3 scale", s.type2_main, art, sess, reads)
        s.phase("profile of one pass", s.profile, sess, reads)
        del art, sess, art_sess
        torch.cuda.empty_cache()
    s.phase("toy Type-II and build through the CLI", s.toy_type2)
    s.phase("device build vs CPU build", s.build_vs_cpu)
    s.phase("build kernels vs plain versions", s.build_kernels)
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
