"""The system under test: ``cammiq_tpu_torch`` driven as ``cli --query``
drives it, one sample (one query file) at a time.

``ensure_index`` builds a configuration's index with the port's own
``build_index`` + ``save_index`` (+ ``prepare_merged`` for a merged
configuration) on a cell's first run in a checkout and keeps it in a fixed
directory under ``perfbench/cache/``; later runs load it.  ``System`` holds
the session and runs a sample through the body of ``cli._run_query`` for the
traffic's mode, on an in-memory ``ReadSet``.  Nothing here is timed; the
harness holds the clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import shutil
import time

import numpy as np

MODES = ("quant", "type1", "type2")


def index_key(cfg: dict) -> str:
    """The cache directory's name: the corpus and build parameters."""
    c, b = cfg["corpus"], cfg["build"]
    return (f"{c['generator']}_g{c['genomes']}_l{c['genome_length']}_s{c['seed']}"
            f"_p{c['shared_pool']}_f{c['shared_len_frac']}"
            f"_k{b['k']}_L{b['L']}_Lmax{b['Lmax']}_h{b['h']}_{b['mode']}")


def ensure_index(cfg: dict, cache_root: str, device: str,
                 log=print) -> tuple:
    """(index directory, genome codes file) of the configuration: the
    directory holds ``index_u.npz``, ``index_d.npz``, the meta files,
    ``merged/`` where the configuration queries a merged artifact, and
    ``genomes.npy``, the database as int8 [G, glen] codes; all built here
    if absent.  A build goes to ``<dir>.partial`` and is renamed when
    whole, so a cut run leaves nothing that a later run would load."""
    import torch

    from . import genomes

    from cammiq_tpu_torch.config import BuildConfig
    from cammiq_tpu_torch.index.artifact import prepare_merged
    from cammiq_tpu_torch.index.builder import build_index, save_index
    from cammiq_tpu_torch.io.fasta import corpus_from_sequences

    out = os.path.join(cache_root, index_key(cfg))
    want_merged = cfg["query"]["index"] == "merged"
    if not os.path.isdir(out):
        part = out + ".partial"
        shutil.rmtree(part, ignore_errors=True)
        t = time.time()
        c = cfg["corpus"]
        db = genomes.gen_genomes(c["genomes"], c["genome_length"], c["seed"],
                                 c["shared_pool"], c["shared_len_frac"])
        art = build_index(corpus_from_sequences(db),
                          BuildConfig(**cfg["build"]), device=device)
        save_index(art, part)
        np.save(os.path.join(part, "genomes.npy"), genomes.genome_codes(db))
        del art, db
        if device != "cpu":
            torch.cuda.empty_cache()
        os.replace(part, out)
        log(f"index built in {time.time() - t:.1f} s -> {out}")
    merged = os.path.join(out, "merged")
    if want_merged and not os.path.isdir(merged):
        part = merged + ".partial"
        shutil.rmtree(part, ignore_errors=True)
        t = time.time()
        prepare_merged(os.path.join(out, "index_u.npz"),
                       os.path.join(out, "index_d.npz"), part)
        os.replace(part, merged)
        log(f"merged artifact in {time.time() - t:.1f} s -> {merged}")
    return merged if want_merged else out, os.path.join(out, "genomes.npy")


@dataclasses.dataclass
class SampleResult:
    """What one sample produced: the session's counts and the mode's
    answer, all on the host, and the host-clock spans of its layers."""

    counts: object                  # cammiq_tpu_torch QueryCounts
    exist: np.ndarray | None = None
    cov: np.ndarray | None = None
    redist: np.ndarray | None = None
    text: str | None = None         # quant: the output block
    spans: dict = dataclasses.field(default_factory=dict)


class System:
    """One query session of the port and the per-sample body of a mode."""

    def __init__(self, cfg: dict, index_dir: str, mode: str, device: str):
        from cammiq_tpu_torch.config import (FineParams, IdentFineParams,
                                             QueryConfig)
        from cammiq_tpu_torch.index.artifact import load_merged_artifact
        from cammiq_tpu_torch.index.table import load_flat_index_pair
        from cammiq_tpu_torch.io.mapfile import (Genome, GenomeTable,
                                                 load_genome_lengths)
        from cammiq_tpu_torch.query.pipeline import QuerySession

        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        q = cfg["query"]
        G = cfg["corpus"]["genomes"] + 1
        self.table = GenomeTable([None] + [Genome(taxid=i, name=f"g{i}")
                                           for i in range(1, G)])
        load_genome_lengths(self.table, index_dir)
        # ``cli --query --max_depth``: the MIQP's largest coverage
        self.fine = FineParams(max_cov=q.get("max_depth", FineParams.max_cov))
        self.identp = IdentFineParams()
        self.erate = q["erate"]
        # as ``cli --query`` builds it: the batch is QueryConfig's own
        qcfg = QueryConfig(h=cfg["build"]["h"], erate=q["erate"],
                           id_mode=MODES.index(mode), fine=self.fine,
                           ident=self.identp)
        if q["index"] == "merged":
            art = load_merged_artifact(index_dir)
            self.index_u, self.index_d = art.payloads()
            self.sess = QuerySession.from_artifact(art, G, qcfg, device=device)
        else:
            self.index_u, self.index_d = load_flat_index_pair(
                os.path.join(index_dir, "index_u.npz"),
                os.path.join(index_dir, "index_d.npz"))
            self.sess = QuerySession(self.index_u, self.index_d, G, qcfg,
                                     device=device, engine=q["engine"])
        self.device = self.sess.device

    def run_sample(self, reads, span=contextlib.nullcontext) -> SampleResult:
        """``cli._run_query``'s per-file body for the mode.  ``span(name)``
        wraps each layer (a profiler range in the traced sample)."""
        from cammiq_tpu_torch.models.ident import solve_ident
        from cammiq_tpu_torch.models.output import write_quant_block
        from cammiq_tpu_torch.models.quant import build_problem, solve_quant

        spans = {}
        t = time.perf_counter()
        with span("pass"):
            counts = self.sess.run(reads, sc_mode=self.mode == "type2",
                                   with_rcounts=self.mode == "quant")
        spans["pass_ms"] = (time.perf_counter() - t) * 1e3
        res = SampleResult(counts=counts, spans=spans)
        if self.mode == "quant":
            gl, nus, nds = self.table.arrays()
            t = time.perf_counter()
            with span("build_problem"):
                prob = build_problem(
                    self.index_u, self.index_d, counts.rcount_u, counts.rcount_d,
                    counts.cnts_u.astype(np.float64),
                    counts.cnts_d.astype(np.float64),
                    nus.astype(np.float64), nds.astype(np.float64), gl,
                    counts.mean_read_len, counts.num_reads, self.erate, self.fine)
            spans["problem_ms"] = (time.perf_counter() - t) * 1e3
            with span("solve_quant"):
                res.exist, res.cov, info = solve_quant(prob, device=self.device)
            spans["solve_ms.quant"] = info["solve_time"] * 1e3
            buf = io.StringIO()
            with span("write_quant_block"):
                write_quant_block(buf, reads.name, self.table, res.exist,
                                  res.cov, last_file=True)
            res.text = buf.getvalue()
        elif self.mode == "type2":
            t = time.perf_counter()
            with span("solve_ident"):
                res.exist, res.redist = solve_ident(
                    counts.cnts_u, counts.cnts_d, counts.pair_counts, self.identp)
            spans["solve_ms.ident"] = (time.perf_counter() - t) * 1e3
        return res

    def close(self) -> None:
        """Drop the session and its device memory."""
        import torch

        self.sess = self.index_u = self.index_d = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def read_set(codes: np.ndarray, name: str):
    from cammiq_tpu_torch.io.fastq import ReadSet

    lengths = np.full(codes.shape[0], codes.shape[1], np.int32)
    return ReadSet(codes=codes, lengths=lengths,
                   total_len=int(lengths.sum()), name=name)
