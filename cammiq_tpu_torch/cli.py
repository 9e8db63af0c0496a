"""Command line: ``python -m cammiq_tpu_torch.cli [--device DEV] <flags>``.

The flags are those of ``cammiq_tpu.cli``; ``_err`` and ``parse_args`` are
copies of it (27-170).  ``--device`` (default ``cuda``) picks the torch
device; a missing card under ``cuda`` raises.

``--build`` runs this package's index build (``index/builder.py``) with
the outputs of ``cammiq_tpu.cli.run_build`` (``.npz`` tables, meta files,
``--merged``), and names on stderr the engine that ran:

  --engine auto|jax|any other (default)     the device build on --device;
                                            a corpus of 2^31 positions or
                                            more raises and names the
                                            host engines
  --engine native                           the host build: the native
                                            bounded sort (SA-IS with
                                            --exact_sa) and C++ sweeps;
                                            numpy where the native
                                            library is not built
  --engine numpy                            the host build in numpy
  --build_hosts H > 1                       the cross-host build
                                            (parallel/dist_build.py) from
                                            a corpus streamed to a
                                            temporary directory, where the
                                            native bounded sort is built;
                                            else the single-host build of
                                            --engine (the native bounded
                                            sort then over H slices)

The index is the JAX CLI's with the same flags (its ``auto`` is the
native engine; the device build gives the same index).  ``--build_hosts
H`` gives ``build_index(num_groups=min(H, 4, M))``'s index, as in
``cammiq_tpu``.

``--query`` runs this package's query session and solvers:

  quantification (default)                  ported
  --read_cnts (Type I)                      ported
  --read_cnts --doubly_unique (Type II)     ported
  -t N > 1, --model_shards M > 1            ported: the distributed query
                                            over a data x model grid of
                                            the launcher's ranks
  --profile DIR                             ported: a torch.profiler trace
                                            of the query loop, one file a
                                            rank

``--engine`` picks the query engine as ``cammiq_tpu.cli`` does (313-315):
``gather`` runs the gather engine (the per-offset probe of both FlatIndex
tables, ``query/classify.py``) for ``.npz`` indexes on one device; ``auto``
and every other value run the bloom -> cuckoo probe join
(``query/sortjoin.py``), which a merged artifact and a grid always take.

The distributed query runs one process a rank under a launcher, e.g. two
ranks on the CPU (gloo) or two cards (NCCL, each rank on
``cuda:LOCAL_RANK``):

    torchrun --nproc_per_node 2 -m cammiq_tpu_torch.cli --device cpu \
        --query -f map.out -i idx_u.npz idx_d.npz -q reads.fq -t 2

Every rank reads the same files; rank 0 alone solves and writes the
output.  Without a launcher, ``-t N`` finds one rank, says so on stderr
and runs the single-device session, as ``cammiq_tpu.cli`` does on one
device.
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import List, Optional

import numpy as np

from .config import BuildConfig, FineParams, IdentFineParams, QueryConfig


def _err(msg: str) -> None:
    print(msg, file=sys.stderr)
    sys.exit(1)


def parse_args(argv: List[str]) -> dict:
    a = {
        "mode": None, "idx_option": None, "id_mode": 0,
        "K": None, "L": None, "Lmax": None, "h": None, "h1": None, "h2": None,
        "fa_dir": "", "fm_name": "", "fq_dir": "", "fq_names": [],
        "fi_u": "", "fi_d": "", "output": "", "erate": 0.0, "t": 1,
        "min_rl": 0, "debug": False,
        "read_cnt_thres": -1.0, "easy_thres": -1.0, "ilp_eps": -1.0,
        "ilp_alpha": -1.0, "max_cov": -1.0,
        "u_thres": -1.0, "d_thres": -1.0,
        "engine": "auto", "profile": "", "model_shards": 1,
        "build_hosts": 0,
        "ilp_time_limit": 10800.0, "ilp_enum_cap": 8, "merged": "",
        "exact_sa": False,
    }
    i = 0
    while i < len(argv):
        v = argv[i]
        if v == "--help":
            print(__doc__)
            sys.exit(0)
        elif v == "--build":
            a["mode"] = 0
        elif v == "--query":
            a["mode"] = 1
        elif v == "--unique":
            if a["mode"] == 0:
                a["idx_option"] = "unique"
        elif v == "--doubly_unique":
            if a["mode"] == 0:
                a["idx_option"] = "doubly_unique"
            else:
                a["id_mode"] = 2
        elif v == "--both":
            a["idx_option"] = "both"
        elif v == "--read_cnts":
            a["id_mode"] = max(a["id_mode"], 1)
        elif v == "--enable_ilp_display":
            a["debug"] = True
        elif v == "--read_length_filter":
            i += 1
            a["min_rl"] = int(argv[i])
        elif v == "--read_cnt_thres":
            i += 1
            a["read_cnt_thres"] = float(argv[i])
        elif v == "--easy_to_identify_thres":
            i += 1
            a["easy_thres"] = float(argv[i])
        elif v == "--ilp_epsilon":
            i += 1
            a["ilp_eps"] = float(argv[i])
        elif v == "--ilp_alpha":
            i += 1
            a["ilp_alpha"] = float(argv[i])
        elif v == "--max_depth":
            i += 1
            a["max_cov"] = float(argv[i])
        elif v == "--merged":
            i += 1
            a["merged"] = argv[i]
        elif v == "--ilp_time_limit":
            i += 1
            a["ilp_time_limit"] = float(argv[i])
        elif v == "--ilp_enum_cap":
            i += 1
            a["ilp_enum_cap"] = int(argv[i])
        elif v == "--unique_read_cnt_thres":
            i += 1
            a["u_thres"] = float(argv[i])
        elif v == "--doubly_unique_read_cnt_thres":
            i += 1
            a["d_thres"] = float(argv[i])
        elif v == "--engine":
            i += 1
            a["engine"] = argv[i]
        elif v == "--exact_sa":
            a["exact_sa"] = True
        elif v == "--model_shards":
            i += 1
            a["model_shards"] = int(argv[i])
        elif v == "--build_hosts":
            i += 1
            a["build_hosts"] = int(argv[i])
        elif v == "--profile":
            i += 1
            a["profile"] = argv[i]
        elif v == "-k":
            i += 1
            a["K"] = int(argv[i])
        elif v == "-L":
            i += 1
            a["L"] = int(argv[i])
        elif v == "-Lmax":
            i += 1
            a["Lmax"] = int(argv[i])
        elif v == "-h":
            vals = []
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                vals.append(int(argv[i]))
            if len(vals) == 1:
                a["h"] = vals[0]
            elif len(vals) >= 2:
                a["h1"], a["h2"] = vals[0], vals[1]
        elif v == "-f":
            i += 1
            a["fm_name"] = argv[i]
        elif v == "-D":
            i += 1
            a["fa_dir"] = argv[i]
        elif v == "-Q":
            i += 1
            a["fq_dir"] = argv[i]
        elif v == "-q":
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                a["fq_names"].append(argv[i])
        elif v == "-i":
            vals = []
            while i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                i += 1
                vals.append(argv[i])
            if vals:
                a["fi_u"] = vals[0]
            if len(vals) > 1:
                a["fi_d"] = vals[1]
        elif v == "-o":
            i += 1
            a["output"] = argv[i]
        elif v == "-e":
            i += 1
            a["erate"] = float(argv[i])
        elif v == "-t":
            i += 1
            a["t"] = int(argv[i])
        else:
            _err(f"Failed to recognize option: {v}.")
        i += 1
    return a


def split_device(argv: List[str]) -> tuple[str, List[str]]:
    """(device, remaining argv) with ``--device X`` removed."""
    device = "cuda"
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 >= len(argv):
                _err("--device needs a value (cuda, cuda:N or cpu).")
            device = argv[i + 1]
            i += 2
            continue
        rest.append(argv[i])
        i += 1
    return device, rest


def run_build(a: dict, device: str) -> None:
    """``--build``: ``cammiq_tpu.cli.run_build`` (196-235) with the engine
    map of this package: ``--engine native|numpy`` the host build,
    ``--build_hosts H > 1`` the cross-host build where the native bounded
    sort is built (else the single-host build with ``sa_hosts=H``), any
    other engine the device build on ``device``."""
    from .index.builder import HOST_ENGINES, build_index, write_meta_outputs
    from .index.table import save_flat_index
    from .io.fasta import build_corpus, list_fasta_dir, read_map_file

    cfg = BuildConfig(
        k=a["K"] or 26,
        L=a["L"] or 100,
        Lmax=a["Lmax"] or 50,
        h=a["h"] or a["h1"] or 26,
        h2=a["h2"],
        mode=a["idx_option"] or "both",
        num_groups=min(a["t"], 4),
        # --exact_sa: full SA-IS sort instead of the depth-bounded suffix
        # sort (identical index; deep-repeat skipped-candidate bookkeeping
        # parity, see BuildConfig.bounded_sa)
        bounded_sa=not a["exact_sa"],
    )
    if a["fm_name"]:
        files = read_map_file(a["fm_name"], a["fa_dir"])
        files.sort(key=lambda x: x[0])  # reference std::map path order
    elif a["fa_dir"]:
        files = list_fasta_dir(a["fa_dir"])
    else:
        _err("Please specify a map file (-f) or fasta directory (-D).")
    hosts = a["build_hosts"]
    use_dist = hosts > 1 and not (cfg.occ_u8_wrap or cfg.unique_if_advance)
    if use_dist:
        from . import native as _native

        use_dist = _native.available() and _native.has_bsort()
    engine = a["engine"] if a["engine"] in HOST_ENGINES else "device"
    if engine == "device" and not use_dist:
        # a missing card raises before the corpus is read
        from .device import resolve_device

        device = resolve_device(device)
    if use_dist:
        # memory-honest cross-host pipeline: the corpus STREAMS to disk
        # (the coordinator holds O(largest contig)), then sharded sort +
        # distributed merge + chunk-carried sweeps + per-shard
        # selection; identical index to
        # build_index(num_groups=min(hosts,4,M)) (the text shards ARE
        # the reference's per-thread selection groups)
        import tempfile

        from .io.fasta import build_corpus_streaming
        from .parallel.dist_build import dist_build_index

        wd = tempfile.mkdtemp(prefix="cammiq_dist_")
        corpus = build_corpus_streaming(
            files, os.path.join(wd, "src_corpus.bin"))
    else:
        corpus = build_corpus(files)
    print(
        f"****************************\n"
        f"Total num bases: {corpus.n}\n"
        f"Total num genomes: {corpus.num_files}\n"
        f"Total num contigs: {corpus.num_contigs}\n"
        f"****************************",
        file=sys.stderr,
    )
    if use_dist:
        print(f"build engine: cross-host, {hosts} slices", file=sys.stderr)
        try:
            art, _ = dist_build_index(corpus, cfg, hosts, wd, verbose=True)
        finally:
            shutil.rmtree(wd, ignore_errors=True)
    else:
        art = build_index(corpus, cfg, device=device, engine=engine,
                          verbose=True, sa_hosts=hosts)
    outdir = os.path.dirname(a["fi_u"]) or "."
    os.makedirs(outdir, exist_ok=True)
    if art.unique_index is not None:
        save_flat_index(a["fi_u"] or os.path.join(outdir, "index_u.npz"),
                        art.unique_index)
    if art.doubly_index is not None:
        save_flat_index(a["fi_d"] or os.path.join(outdir, "index_d.npz"),
                        art.doubly_index)
    write_meta_outputs(art, outdir)
    if a["merged"]:
        if art.unique_index is None:
            _err("--merged requires a unique index (--unique or --both).")
        from .index.artifact import save_merged_artifact
        from .query.merged import build_merged_index

        m = build_merged_index(art.unique_index, art.doubly_index)
        save_merged_artifact(m, art.unique_index, art.doubly_index,
                             a["merged"])
        write_meta_outputs(art, a["merged"])
        print(f"Merged query artifact written to {a['merged']}.",
              file=sys.stderr)


def run_query(a: dict, device: str) -> None:
    """``--query``.  ``-t N > 1`` and ``--model_shards M > 1`` run the
    distributed query (``cammiq_tpu/cli.py:316-343``) over the ranks a
    launcher started: ``model = min(M, W)`` and ``data = min(N if N > 1
    else W // model, W // model)`` for a world of W ranks.  A grid of one
    rank says so and runs the single-device session.  A process group this
    call set up is destroyed when it returns."""
    import torch.distributed as dist

    from .parallel.mesh import ProcessGrid
    from .parallel.multihost import initialize_cluster, local_device

    if a["t"] <= 1 and a["model_shards"] <= 1:
        _run_query(a, device, None)
        return
    own = not dist.is_initialized()
    if initialize_cluster(device):
        device = local_device(device)
    try:
        W = dist.get_world_size() if dist.is_initialized() else 1
        model = max(1, min(a["model_shards"], W))
        data = max(1, min(a["t"] if a["t"] > 1 else W // model, W // model))
        grid = None
        if data * model > 1:
            grid = ProcessGrid(data, model, device)
            if grid.rank == 0:
                print(f"Distributed query mesh: data={data} x model={model}.",
                      file=sys.stderr)
        else:
            print(f"-t {a['t']} requested but only {W} device(s) present; "
                  f"running single-device.", file=sys.stderr)
        if grid is None or grid.active:
            _run_query(a, device, grid)
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()


def _run_query(a: dict, device: str, grid) -> None:
    """The query on one device, or this rank's part of it on ``grid``:
    every rank parses the same files and runs every pass; rank 0 alone
    solves, prints and writes the output file."""
    from .device import resolve_device
    from .index.artifact import is_merged_artifact, load_merged_artifact
    from .index.table import load_flat_index_pair
    from .io.fastq import list_fastq_dir, read_fastq
    from .io.mapfile import load_genome_lengths, load_smap
    from .models import output as outmod
    from .models.ident import solve_ident
    from .models.quant import build_problem, solve_quant
    from .query.pipeline import QuerySession
    from .utils.profiling import device_trace

    dev = resolve_device(device)
    rank = grid.rank if grid is not None else 0
    lead = rank == 0
    if not a["fi_u"]:
        _err("Please specify index files (-i).")
    artifact = None
    if is_merged_artifact(a["fi_u"]):
        artifact = load_merged_artifact(a["fi_u"])
        index_u, index_d = artifact.payloads()
    else:
        index_u, index_d = load_flat_index_pair(
            a["fi_u"],
            a["fi_d"] if a["fi_d"] and os.path.exists(a["fi_d"]) else None)

    table = load_smap(a["fm_name"])
    idx_dir = (a["fi_u"] if artifact is not None
               else os.path.dirname(a["fi_u"]) or ".")
    if a["id_mode"] == 0:
        load_genome_lengths(table, idx_dir, require_doubly=index_d is not None)
    G = table.n_species + 1

    fine = FineParams(
        read_cnt_thres=int(a["read_cnt_thres"]) if a["read_cnt_thres"] > 0 else 100,
        easy_to_identify_thres=int(a["easy_thres"]) if a["easy_thres"] > 0 else 10000,
        ilp_epsilon=a["ilp_eps"] if a["ilp_eps"] > 0 else 0.01,
        ilp_alpha=a["ilp_alpha"] if a["ilp_alpha"] > 0 else 0.0001,
        max_cov=a["max_cov"] if a["max_cov"] > 0 else 100.0,
    )
    identp = IdentFineParams(
        unique_read_cnt_thres=int(a["u_thres"]) if a["u_thres"] > 0 else 10,
        doubly_unique_read_cnt_thres=int(a["d_thres"]) if a["d_thres"] > 0 else 5,
    )
    qcfg = QueryConfig(h=index_u.h, erate=a["erate"], min_read_len=a["min_rl"],
                       id_mode=a["id_mode"], fine=fine, ident=identp)
    engine = {"auto": "sortjoin"}.get(a["engine"], a["engine"])
    if engine not in ("sortjoin", "gather"):
        engine = "sortjoin"
    if artifact is not None:
        sess = QuerySession.from_artifact(artifact, G, qcfg, device=dev,
                                          grid=grid)
    else:
        sess = QuerySession(index_u, index_d, G, qcfg, device=dev, grid=grid,
                            engine=engine)

    files = a["fq_names"] or (list_fastq_dir(a["fq_dir"]) if a["fq_dir"] else [])
    if not files:
        _err("Please specify at least one query file or directory.")
    out_path = a["output"] or "./quantification_results.out"
    gl, nus, nds = table.arrays()
    mode = "w"
    with device_trace(a["profile"], dev, rank):
        for fi, path in enumerate(files):
            reads = read_fastq(path, min_len=a["min_rl"])
            # Type-I needs only cnts_u, which sc mode leaves unchanged
            counts = sess.run(reads, sc_mode=a["id_mode"] == 2,
                              with_rcounts=a["id_mode"] == 0, verbose=lead)
            if not lead:        # the other ranks of a grid only classify
                continue
            print(f"Number of unlabeled reads: {counts.nundet}.", file=sys.stderr)
            print(f"Number of reads with conflict labels: {counts.nconf}.",
                  file=sys.stderr)
            name = os.path.basename(path)
            with open(out_path, mode) as f:
                if a["id_mode"] == 0:
                    prob = build_problem(
                        index_u, index_d, counts.rcount_u, counts.rcount_d,
                        counts.cnts_u.astype(np.float64),
                        counts.cnts_d.astype(np.float64),
                        nus.astype(np.float64), nds.astype(np.float64),
                        gl, counts.mean_read_len, counts.num_reads,
                        a["erate"], fine,
                    )
                    exist, cov, info = solve_quant(
                        prob, verbose=a["debug"], time_limit=a["ilp_time_limit"],
                        enum_cap=a["ilp_enum_cap"], device=dev)
                    print(f"{int(prob.exist0.sum())} genomes may exist in query "
                          f"{name}.", file=sys.stderr)
                    print(f"Time for quantification: "
                          f"{info['solve_time']*1e3:.0f} ms.", file=sys.stderr)
                    outmod.write_quant_block(f, name, table, exist, cov,
                                             last_file=(fi == len(files) - 1))
                elif a["id_mode"] == 1:
                    if fi == 0:
                        outmod.write_counts_header(f, table)
                    outmod.write_counts_row(f, name, counts.cnts_u,
                                            table.n_species)
                else:
                    if fi == 0:
                        outmod.write_counts_header(f, table)
                    exist, redist = solve_ident(
                        counts.cnts_u, counts.cnts_d, counts.pair_counts, identp)
                    outmod.write_counts_row(f, name, redist, table.n_species)
            mode = "a"


def main(argv: Optional[List[str]] = None) -> None:
    device, rest = split_device(list(sys.argv[1:] if argv is None else argv))
    a = parse_args(rest)
    if a["mode"] == 0:
        run_build(a, device)
    elif a["mode"] == 1:
        run_query(a, device)
    else:
        _err("Specify --build or --query.")


if __name__ == "__main__":
    main()
