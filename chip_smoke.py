#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cammiq_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device (written for an H100), the CUDA toolkit (nvcc) and a
C++ compiler with OpenMP.  It builds everything from this checkout, imports
nothing of JAX, and exits nonzero if any phase fails:

1. header: the card's name and power limit, torch/CUDA/nvcc versions; the
   three CUDA kernels are compiled (build seconds printed);
2. set-up: the config-#3-shape index (bench.py's generator: 1000 genomes x
   300 kb, k=26 L=100 Lmax=50 h=26), built on the host once into the
   git-ignored bench_cache/ (cold build seconds printed);
3. kernels on the card: each kernel against its plain PyTorch version on
   the same CUDA tensors at the main path's shapes (one batch of 8192 reads
   x 100 bases; the scan also at n = 2^20), exact equality required,
   median CUDA-event times of both;
4. toy end to end through the CLI (5 x 2000 bp genomes, 4000 simulated
   reads): quant abundances within 0.01 of the truth for all 5 genomes, a
   Type-I file identical to the one the CPU path writes;
5. main path at config-#3 scale: QuerySession.from_artifact on cuda over 16
   batches of 8192 reads, then build_problem + solve_quant; the kernels'
   launch counters are zeroed just before and read just after, and every
   kernel must have launched; one batch must give identical counts through
   the kernels (cuda) and the plain versions (cpu).  Steady-state reads/s,
   session start and peak device memory are printed;
6. profile: one more pass under torch.profiler, device time by kernel and
   the device's busy share of the pass's wall time (the table also goes to
   chiprun_out/chip_smoke_profile.txt).

Before the last line it prints the nvidia-smi line and one JSON object
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Numbers and logs also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
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

KERNEL_INFO = {
    "first_of_run": ("cammiq_tpu_torch/csrc/first_of_run.cu",
                     "benchmarks/pallas_repro.py:79"),
    "probe_bloom": ("cammiq_tpu_torch/csrc/probe_bloom.cu",
                    "cammiq_tpu/query/sortjoin.py:867"),
    "cuckoo_verify": ("cammiq_tpu_torch/csrc/cuckoo_verify.cu",
                      "cammiq_tpu/query/sortjoin.py:1142"),
}


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


def ensure_native_library() -> None:
    """Build native/libcammiq_native.so (the C++ engine of the host index
    build) if absent.  The default compiler is tried first, then the
    system g++ (the first may lack OpenMP)."""
    native_dir = os.path.join(REPO, "native")
    so = os.path.join(native_dir, "libcammiq_native.so")
    tried = []
    if not os.path.exists(so):
        for cxx in dict.fromkeys([os.environ.get("CXX", "g++"), "/usr/bin/g++"]):
            r = subprocess.run(["make", "-C", native_dir, f"CXX={cxx}"],
                               capture_output=True, text=True, timeout=600)
            tried.append(f"CXX={cxx}: rc={r.returncode} {r.stderr[-500:]}")
            if r.returncode == 0 and os.path.exists(so):
                break
    from cammiq_tpu import native

    if not native.available():
        raise RuntimeError("native index library unavailable: " + " | ".join(tried))


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


def max_abs_err(a, b) -> int:
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max()) if a.numel() else 0


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

    # ---- 1. header + kernel build
    def header(self):
        import torch

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

    # ---- 2. realistic index (host)
    def realistic_index(self):
        ensure_native_library()
        import bench

        t = time.time()
        mdir = bench.ensure_production_index()
        self.results["index_build_s"] = time.time() - t
        self.results["genomes"] = bench.BENCH_GENOMES
        self.results["genome_len"] = bench.BENCH_GLEN
        log(f"index ({bench.BENCH_GENOMES} x {bench.BENCH_GLEN} bp): "
            f"{self.results['index_build_s']:.1f} s -> {mdir}")
        return mdir

    def reads(self):
        import numpy as np

        import bench
        from cammiq_tpu.io.fastq import ReadSet

        genomes = bench.gen_bench_genomes()
        rng = np.random.default_rng(1)
        parts = [bench.sample_read_batch(rng, genomes, BATCH)
                 for _ in range(N_BATCHES)]
        codes = np.concatenate([p[0] for p in parts])
        lengths = np.concatenate([p[1] for p in parts])
        return ReadSet(codes=codes, lengths=lengths,
                       total_len=int(lengths.sum()), name="bench")

    def session(self, mdir):
        import torch

        import bench
        from cammiq_tpu.config import QueryConfig
        from cammiq_tpu.index.artifact import load_merged_artifact
        from cammiq_tpu_torch.query.pipeline import QuerySession

        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        art = load_merged_artifact(mdir)
        sess = QuerySession.from_artifact(
            art, bench.BENCH_GENOMES + 1,
            QueryConfig(h=art.h, erate=0.01, batch_size=BATCH), device="cuda")
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
        # record each wrapper's arguments during one real batch
        captured = {}
        originals = {}
        for name in ("probe_bloom", "cuckoo_verify", "first_of_run_scan"):
            orig = getattr(sj, name)
            originals[name] = orig

            def rec(*a, _n=name, _f=orig):
                captured[_n] = a
                return _f(*a)

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
        cases = [
            ("probe_bloom", kpb.probe_bloom, kpb.probe_bloom_plain,
             captured["probe_bloom"]),
            ("cuckoo_verify", kcv.cuckoo_verify, kcv.cuckoo_verify_plain,
             captured["cuckoo_verify"]),
            ("first_of_run", kfr.first_of_run_scan, kfr.first_of_run_scan_plain,
             captured["first_of_run_scan"]),
            ("first_of_run@2^20", kfr.first_of_run_scan,
             kfr.first_of_run_scan_plain, scan_big),
        ]
        for name, kern, plain, args in cases:
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_abs_err(g, w) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = cuda_median_ms(lambda: kern(*args))
            plain_ms = cuda_median_ms(lambda: plain(*args))
            shape = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            log(f"{name}: shapes {shape} equal={same} max_abs_err={err} "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            self.kernels[name] = {"max_abs_err": err, "ms": ms,
                                  "plain_ms": plain_ms, "shapes": shape}
            if not same:
                raise AssertionError(f"{name}: kernel != plain version")

    # ---- 4. toy end to end through the CLI
    def toy_cli(self):
        import numpy as np

        from cammiq_tpu.models.output import parse_quant_output
        from cammiq_tpu.tools.simulate import simulate
        from cammiq_tpu_torch import cli
        from cammiq_tpu_torch.kernels import cuckoo_verify, first_of_run, probe_bloom

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
            cli.main(["--build", "--both", "-f", mapf, "-D", db, "-k", "20",
                      "-L", "100", "-Lmax", "40", "-h", "20", "-i", iu, idd])
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

        import bench
        from cammiq_tpu.config import FineParams
        from cammiq_tpu.io.mapfile import Genome, GenomeTable, load_genome_lengths
        from cammiq_tpu.models.quant import build_problem
        from cammiq_tpu_torch.kernels import cuckoo_verify, first_of_run, probe_bloom
        from cammiq_tpu_torch.models.quant import solve_quant
        from cammiq_tpu_torch.query.sortjoin import TorchMergedIndex, classify_batch

        kerns = {"probe_bloom": probe_bloom.KERNEL,
                 "cuckoo_verify": cuckoo_verify.KERNEL,
                 "first_of_run": first_of_run.KERNEL}
        G = bench.BENCH_GENOMES + 1
        table = GenomeTable([None] + [Genome(taxid=i, name=f"g{i}")
                                      for i in range(1, G)])
        load_genome_lengths(table, art.path)
        gl, nus, nds = table.arrays()
        index_u, index_d = art.payloads()
        fine = FineParams()

        for k in kerns.values():
            k.launches = 0
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
        launches = {name: k.launches for name, k in kerns.items()}
        self.results["launches"] = launches
        log(f"main path (first run incl. solve): {first_s:.3f} s, maxm "
            f"{sess.maxm}, launches {launches}")
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the path was not launched: {launches}")
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

    # ---- 6. where a steady-state pass spends device time
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

    def report(self, device_name: str, smi: str):
        import torch

        kernels = []
        main_launch = self.results.get("launches", {})
        for name, (src, replaces) in KERNEL_INFO.items():
            k = self.kernels.get(name, {})
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": main_launch.get(name, 0),
                            "max_abs_err": k.get("max_abs_err"),
                            "ms": k.get("ms"), "plain_ms": k.get("plain_ms")})
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
        import bench  # noqa: F401  (the repo's index generator)
        import cammiq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {device_name} ({smi})")
    s = Smoke()
    s.phase("header + kernel build", s.header)
    if s.failed:
        return 1
    mdir = s.phase("config-#3 index (host, cold)", s.realistic_index)
    reads = s.phase("reads", s.reads)
    art_sess = s.phase("session", s.session, mdir) if mdir and reads else None
    if art_sess:
        art, sess = art_sess
        s.phase("kernels vs plain versions", s.kernels_vs_plain, sess, reads)
    s.phase("toy end to end through the CLI", s.toy_cli)
    if art_sess:
        s.phase("main path at config-#3 scale", s.main_path, art, sess, reads)
        s.phase("profile of one pass", s.profile, sess, reads)
    if "jax" in sys.modules:
        s.failed.append("jax was imported")
    if s.failed or not art_sess:
        log(f"FAILED phases: {s.failed}")
        return 1
    s.report(device_name, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
