"""Command line: ``python -m cammiq_tpu_torch.cli [--device DEV] <flags>``.

The flags are those of ``cammiq_tpu.cli`` (parsed by its ``parse_args``).
``--device`` (default ``cuda``) picks the torch device; a missing card
under ``cuda`` raises.

``--build --engine jax`` runs this package's device index build
(``index/builder.py``) on ``--device``, with the outputs of
``cammiq_tpu.cli.run_build`` (``.npz`` tables, meta files, ``--merged``).
Every other engine, and ``--build_hosts > 1`` (the host distributed
builder), runs the shared host build, ``cammiq_tpu.cli.run_build``.

``--query`` runs this package's query session and solvers:

  quantification (default)                  ported
  --read_cnts (Type I)                      ported
  --read_cnts --doubly_unique (Type II)     ported
  -t N > 1, --model_shards > 1              not ported yet: raise
                                            NotImplementedError

The query path always takes the bloom -> cuckoo probe join; ``--engine``
is accepted and ignored (the JAX package's engines are equality-tested).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from cammiq_tpu.cli import _err, parse_args, run_build
from cammiq_tpu.config import BuildConfig, FineParams, IdentFineParams, QueryConfig


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


def run_device_build(a: dict, device: str) -> None:
    """``--build --engine jax``: the single-host branch of
    ``cammiq_tpu.cli.run_build`` with the device stages on ``device``."""
    from cammiq_tpu.index.builder import write_meta_outputs
    from cammiq_tpu.index.table import save_flat_index
    from cammiq_tpu.io.fasta import build_corpus, list_fasta_dir, read_map_file

    from .device import resolve_device
    from .index.builder import build_index

    dev = resolve_device(device)
    cfg = BuildConfig(
        k=a["K"] or 26,
        L=a["L"] or 100,
        Lmax=a["Lmax"] or 50,
        h=a["h"] or a["h1"] or 26,
        h2=a["h2"],
        mode=a["idx_option"] or "both",
        num_groups=min(a["t"], 4),
        bounded_sa=not a["exact_sa"],
    )
    if a["fm_name"]:
        files = read_map_file(a["fm_name"], a["fa_dir"])
        files.sort(key=lambda x: x[0])  # reference std::map path order
    elif a["fa_dir"]:
        files = list_fasta_dir(a["fa_dir"])
    else:
        _err("Please specify a map file (-f) or fasta directory (-D).")
    corpus = build_corpus(files)
    print(
        f"****************************\n"
        f"Total num bases: {corpus.n}\n"
        f"Total num genomes: {corpus.num_files}\n"
        f"Total num contigs: {corpus.num_contigs}\n"
        f"****************************",
        file=sys.stderr,
    )
    art = build_index(corpus, cfg, device=dev, verbose=True)
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
        from cammiq_tpu.index.artifact import save_merged_artifact
        from cammiq_tpu.query.sortjoin import build_merged_index

        m = build_merged_index(art.unique_index, art.doubly_index)
        save_merged_artifact(m, art.unique_index, art.doubly_index,
                             a["merged"])
        write_meta_outputs(art, a["merged"])
        print(f"Merged query artifact written to {a['merged']}.",
              file=sys.stderr)


def run_query(a: dict, device: str) -> None:
    from cammiq_tpu.index.artifact import is_merged_artifact, load_merged_artifact
    from cammiq_tpu.index.table import load_flat_index_pair
    from cammiq_tpu.io.fastq import list_fastq_dir, read_fastq
    from cammiq_tpu.io.mapfile import load_genome_lengths, load_smap
    from cammiq_tpu.models import output as outmod
    from cammiq_tpu.models.ident import solve_ident
    from cammiq_tpu.models.quant import build_problem

    from .device import resolve_device
    from .models.quant import solve_quant
    from .query.pipeline import QuerySession

    if a["t"] > 1 or a["model_shards"] > 1:
        raise NotImplementedError(
            "distributed query (-t > 1, --model_shards > 1) is not ported "
            "to cammiq_tpu_torch yet")
    dev = resolve_device(device)
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
    if artifact is not None:
        sess = QuerySession.from_artifact(artifact, G, qcfg, device=dev)
    else:
        sess = QuerySession(index_u, index_d, G, qcfg, device=dev)

    files = a["fq_names"] or (list_fastq_dir(a["fq_dir"]) if a["fq_dir"] else [])
    if not files:
        _err("Please specify at least one query file or directory.")
    out_path = a["output"] or "./quantification_results.out"
    gl, nus, nds = table.arrays()
    mode = "w"
    for fi, path in enumerate(files):
        reads = read_fastq(path, min_len=a["min_rl"])
        # Type-I needs only cnts_u, which sc mode leaves unchanged
        counts = sess.run(reads, sc_mode=a["id_mode"] == 2,
                          with_rcounts=a["id_mode"] == 0, verbose=True)
        print(f"Number of unlabeled reads: {counts.nundet}.", file=sys.stderr)
        print(f"Number of reads with conflict labels: {counts.nconf}.", file=sys.stderr)
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
                outmod.write_counts_row(f, name, counts.cnts_u, table.n_species)
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
        if a["engine"] == "jax" and a["build_hosts"] <= 1:
            run_device_build(a, device)
        else:
            run_build(a)
    elif a["mode"] == 1:
        run_query(a, device)
    else:
        _err("Specify --build or --query.")


if __name__ == "__main__":
    main()
