"""Index build: the device engine (the default) and the host engines.

``build_index(corpus, cfg, device="cuda", engine="device", verbose=False,
stage_dir=None, sa_hosts=0)`` turns a host ``Corpus`` (``io/fasta.py``) into
``BuildArtifacts``, stage timings included, and dispatches on ``engine``:

- ``"native"`` and ``"numpy"`` run the host flow of
  ``cammiq_tpu/index/builder.py:build_index`` (94-253, its jax branches
  left out), copied: the native bounded suffix sort when
  ``cfg.bounded_sa`` and ``native.has_bsort()`` (across ``sa_hosts`` > 1
  corpus slices through ``parallel/dist_build.py:dist_bounded_sa``), SA-IS
  otherwise (``--exact_sa``), the C++ sweeps with their narrow dtypes, and
  the numpy engine (``ops/*_host.py``, ``index/unique_host.py``) where the
  native library is absent, as ``cammiq_tpu/index/builder.py:45-56,94-97``
  falls back.  No device is used.
- Every other value (``"device"``, ``"auto"``, ``"jax"``) runs the device
  flow on ``device``: the port of ``build_index(engine="jax")`` (119-253).
  Suffix array, LCP, GSA, LCP0, OCC and MU run on the device; the
  sparsified selection (``index/sparsify.py:select_substrings``) and the
  flat tables (``index/table.py:build_flat_index``) on the host.  Its sort
  takes texts of fewer than 2^31 positions; a longer corpus raises before
  any device work and names the host engines.

Selection in the device flow runs with ``engine="auto"``: the C++ sweep
where the native library is built (the host build's engine at scale),
else the vectorised numpy path.  The JAX device engine passes ``"fast"``;
the engines give the same output (``select_substrings``' docstring), and
the port's tests hold the whole index to ``cammiq_tpu``'s.

``stage_dir`` stages each flow's stages in ``index/staging.py``'s format,
under the JAX engines' names and dtypes: the host flow exactly as the JAX
host flow (``bsa{d}``, ``bsa{d}_h{H}``, ``blcp16_{d}``, ``sa``, ``lcp16``,
``lcp``), the device flow its full-sort ``sa`` (int64 [n]) and ``lcp``
(int64 [n + 1]) as the JAX numpy and jax engines do.  A stage directory
written by ``cammiq_tpu`` resumes a build here, and the reverse, wherever
the names coincide.

``BuildArtifacts``, ``write_meta_outputs`` and ``save_index`` are copies of
``cammiq_tpu/index/builder.py`` (34-42, 266-291).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Optional

import numpy as np

from ..config import BuildConfig
from ..io.fasta import Corpus
from ..ops.lcp_host import lcp_from_sa_numpy
from ..ops.sa_host import suffix_array_numpy
from ..utils.timing import Timings, stage_timer
from .sparsify import select_substrings
from .staging import StageStore, staged
from .table import FlatIndex, build_flat_index, save_flat_index
from .unique_host import (
    DoublyResult,
    compute_gsa,
    doubly_lcp0,
    min_unique,
    occ_doubly,
    occ_unique,
    unique_lcp0,
)

HOST_ENGINES = ("native", "numpy")


@dataclasses.dataclass
class BuildArtifacts:
    unique_index: Optional[FlatIndex]
    doubly_index: Optional[FlatIndex]
    ulm_count_u: Optional[np.ndarray]   # per-file unique-L-mer counts
    ulm_count_d: Optional[np.ndarray]
    genome_lengths: np.ndarray          # per-file
    corpus: Corpus
    timings: Timings


def build_index(corpus: Corpus, cfg: BuildConfig, device="cuda",
                engine: str = "device", verbose: bool = False,
                stage_dir: Optional[str] = None,
                sa_hosts: int = 0) -> BuildArtifacts:
    """Build the unique and/or doubly index (``cfg.mode``) of ``corpus``:
    ``engine`` "native" or "numpy" on the host, any other value on
    ``device`` (module docstring)."""
    store = StageStore(stage_dir) if stage_dir is not None else None
    if engine in HOST_ENGINES:
        return _build_host(corpus, cfg, engine, verbose, store, sa_hosts)
    return _build_device(corpus, cfg, device, verbose, store)


def _suffix_array(seq_with_sentinels: np.ndarray, engine: str) -> np.ndarray:
    if engine == "native":
        from .. import native

        if native.available():
            return native.suffix_array(seq_with_sentinels)
    return suffix_array_numpy(seq_with_sentinels)


def _lcp(seq: np.ndarray, sa: np.ndarray, engine: str) -> np.ndarray:
    if engine == "native":
        from .. import native

        if native.available():
            return native.lcp_kasai(seq, sa)
    return lcp_from_sa_numpy(seq, sa)


def _build_host(corpus: Corpus, cfg: BuildConfig, engine: str, verbose: bool,
                store: Optional[StageStore], sa_hosts: int) -> BuildArtifacts:
    """The host flow of ``cammiq_tpu/index/builder.py:build_index`` for
    engine "native" or "numpy" (its lines 94-253 without the jax branches)."""
    timings = Timings()
    n = corpus.n
    # production host path: the C++ streaming sweeps with tight dtypes
    # (lcp uint16, gsa int32, occ uint8, mu uint16), the layout that keeps
    # a multi-gigabase corpus within the reference's ~37N-byte RAM budget
    # (README.md:187); the numpy engine remains the oracle twin
    from .. import native

    sweeps = engine == "native" and native.has_sweeps()
    bounded = sweeps and cfg.bounded_sa and native.has_bsort()
    if verbose:
        if bounded:
            what = "native bounded sort" + (
                f" over {sa_hosts} slices" if sa_hosts > 1 else "")
        elif sweeps:
            what = "native SA-IS"
        else:
            what = "numpy" + (" (native library unavailable: "
                              f"{native.build_error()})" if engine == "native"
                              else "")
        print(f"build engine: {what}, host", file=sys.stderr)
    # the reference computes the SA over n + sentinels but keeps ranks of
    # the n real suffixes only (divsufsort over n chars; src/build.cpp:286)
    with stage_timer("computing suffix array", timings, verbose):
        if bounded:
            # depth-bounded suffix sort: exact for every consumer that
            # thresholds LCPs at <= L+2 (all of them); parallel, one
            # counting-sort pass + per-bucket bounded sorts
            if sa_hosts > 1:
                from ..parallel.dist_build import dist_bounded_sa

                sa = staged(store, f"bsa{cfg.sa_depth}_h{sa_hosts}",
                            lambda: dist_bounded_sa(corpus.seq, cfg.sa_depth,
                                                    sa_hosts))
            else:
                sa = staged(store, f"bsa{cfg.sa_depth}",
                            lambda: native.bounded_sa(corpus.seq, cfg.sa_depth))
        else:
            sa = staged(store, "sa",
                        lambda: _suffix_array(corpus.seq, engine)[:n])
    with stage_timer("computing LCP array", timings, verbose):
        if bounded:
            lcp = staged(store, f"blcp16_{cfg.sa_depth}",
                         lambda: native.bounded_lcp_u16(corpus.seq, sa,
                                                        cfg.sa_depth))
        elif sweeps:
            lcp = staged(store, "lcp16",
                         lambda: native.kasai_u16(corpus.seq[:n], sa))
        else:
            lcp = staged(store, "lcp", lambda: _lcp(corpus.seq, sa, engine))
    with stage_timer("computing generalized suffix array", timings, verbose):
        if sweeps:
            gsa = native.gsa32(sa, corpus.ref_pos, corpus.ref_id)
        else:
            gsa = compute_gsa(sa, corpus.ref_pos, corpus.ref_id)

    unique_index = None
    doubly_index = None
    ulm_u = None
    ulm_d = None

    el = cfg.k - 1            # minuL - 1 (src/build.cpp:289)
    ulmax = cfg.L             # passed as ulmax to run() (src/build.cpp:289)

    if cfg.mode in ("unique", "both"):
        with stage_timer("computing LCP0 array", timings, verbose):
            if sweeps:
                lcp0 = native.unique_lcp0_32(gsa, lcp, el)
            else:
                lcp0 = unique_lcp0(gsa, lcp, el)
        with stage_timer("computing OCC array", timings, verbose):
            if sweeps:
                occ = native.occ_unique_u8(sa, gsa, lcp, lcp0,
                                           wrap=cfg.occ_u8_wrap)
            else:
                occ = occ_unique(sa, gsa, lcp, lcp0, wrap_u8=cfg.occ_u8_wrap)
        with stage_timer("computing minimum unique substrings", timings, verbose):
            if sweeps:
                mu = native.min_unique_u16(sa, lcp0, n)
            else:
                mu = min_unique(sa, lcp0, n)
        with stage_timer("organizing index", timings, verbose):
            sel = select_substrings(
                corpus, mu, occ, cfg.L, cfg.Lmax, num_groups=cfg.num_groups,
                engine="native" if sweeps else "fast",
                unique_if_advance=cfg.unique_if_advance,
            )
            unique_index = build_flat_index(corpus.seq, sel, cfg.h, cfg.Lmax, False)
            ulm_u = sel.ulm_count
        # free per-stage arrays before the doubly pass (each is gigabytes
        # at a multi-GB corpus)
        del lcp0, occ, mu, sel

    if cfg.mode in ("doubly_unique", "both"):
        with stage_timer("computing LCP0-D array", timings, verbose):
            if sweeps:
                dl, g2 = native.doubly_lcp0_32(sa, gsa, lcp, el, ulmax)
                dres = DoublyResult(dl, g2)
            else:
                dres = doubly_lcp0(sa, gsa, lcp, el, ulmax)
        with stage_timer("computing OCC array (doubly)", timings, verbose):
            if sweeps:
                occ_d, occ2_d = native.occ_doubly_u8(
                    sa, gsa, dres.gsa2, lcp, dres.lcp0, ulmax,
                    wrap=cfg.occ_u8_wrap)
            else:
                occ_d, occ2_d = occ_doubly(sa, gsa, dres.gsa2, lcp, dres.lcp0,
                                           ulmax, wrap_u8=cfg.occ_u8_wrap)
        with stage_timer("computing minimum unique substrings (doubly)", timings, verbose):
            if sweeps:
                mu_d = native.min_unique_u16(sa, dres.lcp0, n, ulmax=ulmax)
            else:
                mu_d = min_unique(sa, dres.lcp0, n, ulmax=ulmax)
        with stage_timer("organizing index (doubly)", timings, verbose):
            sel_d = select_substrings(
                corpus, mu_d, occ_d, cfg.L, cfg.Lmax,
                gsa2_text=dres.gsa2, occ2=occ2_d, num_groups=cfg.num_groups,
                engine="native" if sweeps else "fast",
            )
            doubly_index = build_flat_index(
                corpus.seq, sel_d, cfg.h_doubly, cfg.Lmax, True
            )
            ulm_d = sel_d.ulm_count

    return BuildArtifacts(
        unique_index=unique_index,
        doubly_index=doubly_index,
        ulm_count_u=ulm_u,
        ulm_count_d=ulm_d,
        genome_lengths=corpus.genome_lengths(),
        corpus=corpus,
        timings=timings,
    )


def _build_device(corpus: Corpus, cfg: BuildConfig, device, verbose: bool,
                  store: Optional[StageStore]) -> BuildArtifacts:
    """The device flow: the stages on ``device``, selection on the host.
    torch is imported here, so the host engines and the cross-host build
    (whose coordinator's RSS its workers report) never load it."""
    import torch

    from ..device import resolve_device
    from ..kernels.lcp_pairs import LCP_CLAMP, lcp_pairs
    from ..ops.sa import suffix_array
    from . import unique as uq

    def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
        """Device tensor -> numpy (narrowed on the device first, which cuts
        the transfer)."""
        return (t if dtype is None else t.to(dtype)).cpu().numpy()

    def _staged_device(name: str, compute):
        """``compute()`` (an int32 device tensor); with a store, the stage
        ``name`` in the JAX engines' int64 on the host, loaded if present."""
        if store is None:
            return compute()
        arr = staged(store, name, lambda: _host(compute(), torch.int64))
        return torch.from_numpy(np.asarray(arr, np.int32)).to(dev)

    n = corpus.n
    if n >= 2**31:
        raise ValueError(
            f"the device build sorts fewer than 2^31 positions and this "
            f"corpus has {n}: build it on the host (--engine native) or "
            f"across hosts (--build_hosts H)")
    if cfg.occ_u8_wrap:
        raise ValueError("occ_u8_wrap (bit-parity mode) requires a host engine")
    dev = resolve_device(device)
    timings = Timings()
    if verbose:
        print(f"build engine: device ({dev})", file=sys.stderr)

    @contextlib.contextmanager
    def stage(name):
        # device stages end in a sync, so each one's time is its own;
        # verbose also reports each stage's peak device memory (and so
        # resets the peak counter)
        cuda = dev.type == "cuda"
        if cuda and verbose:
            torch.cuda.reset_peak_memory_stats(dev)
        with stage_timer(name, timings, verbose):
            yield
            if cuda:
                torch.cuda.synchronize(dev)
        if cuda and verbose:
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"Peak device memory for {name}: {peak / 2**20:.0f} MiB.",
                  file=sys.stderr)

    with stage("computing suffix array"):
        text = torch.from_numpy(np.array(corpus.seq, np.uint8)).to(dev)
        sa = _staged_device("sa", lambda: suffix_array(text))
    with stage("computing LCP array"):
        lcp = _staged_device("lcp", lambda: lcp_pairs(text, sa, LCP_CLAMP))
        del text
    with stage("computing generalized suffix array"):
        gsa = uq.compute_gsa(sa, corpus.ref_pos, corpus.ref_id)

    el = cfg.k - 1            # minuL - 1 (reference src/build.cpp:289)
    ulmax = cfg.L
    unique_index = doubly_index = ulm_u = ulm_d = None

    if cfg.mode in ("unique", "both"):
        with stage("computing LCP0 array"):
            lcp0 = uq.unique_lcp0(gsa, lcp, el)
        with stage("computing OCC array"):
            occ = _host(uq.occ_unique(sa, gsa, lcp, lcp0), torch.uint8)
        with stage("computing minimum unique substrings"):
            mu = _host(uq.min_unique(sa, lcp0, n))
            del lcp0
        with stage("organizing index"):
            sel = select_substrings(corpus, mu, occ, cfg.L, cfg.Lmax,
                                    num_groups=cfg.num_groups, engine="auto",
                                    unique_if_advance=cfg.unique_if_advance)
            unique_index = build_flat_index(corpus.seq, sel, cfg.h, cfg.Lmax,
                                            False)
            ulm_u = sel.ulm_count
            del occ, mu, sel

    if cfg.mode in ("doubly_unique", "both"):
        with stage("computing LCP0-D array"):
            dl, g2 = uq.doubly_lcp0(sa, gsa, lcp, el, ulmax)
        with stage("computing OCC array (doubly)"):
            occ_d, occ2_d = uq.occ_doubly(sa, gsa, g2, lcp, dl, ulmax)
            occ_d, occ2_d = _host(occ_d, torch.uint8), _host(occ2_d, torch.uint8)
        with stage("computing minimum unique substrings (doubly)"):
            mu_d = _host(uq.min_unique(sa, dl, n, ulmax=ulmax))
            gsa2 = _host(g2)
            del dl, g2
        with stage("organizing index (doubly)"):
            sel_d = select_substrings(corpus, mu_d, occ_d, cfg.L, cfg.Lmax,
                                      gsa2_text=gsa2, occ2=occ2_d,
                                      num_groups=cfg.num_groups, engine="auto")
            doubly_index = build_flat_index(corpus.seq, sel_d, cfg.h_doubly,
                                            cfg.Lmax, True)
            ulm_d = sel_d.ulm_count

    return BuildArtifacts(
        unique_index=unique_index, doubly_index=doubly_index,
        ulm_count_u=ulm_u, ulm_count_d=ulm_d,
        genome_lengths=corpus.genome_lengths(), corpus=corpus,
        timings=timings)


def write_meta_outputs(art: BuildArtifacts, outdir: str) -> None:
    """genome_lengths.out + unique_lmer_count_{u,d}.out, byte-compatible
    with the reference (src/build.cpp:671-738)."""
    os.makedirs(outdir, exist_ok=True)
    rid = art.corpus.ref_id
    if art.ulm_count_u is not None:
        with open(os.path.join(outdir, "unique_lmer_count_u.out"), "w") as f:
            for i in range(len(rid)):
                f.write(f"{int(rid[i])}\t{int(art.ulm_count_u[i])}\n")
    if art.ulm_count_d is not None:
        with open(os.path.join(outdir, "unique_lmer_count_d.out"), "w") as f:
            for i in range(len(rid)):
                f.write(f"{int(rid[i])}\t{int(art.ulm_count_d[i])}\n")
    with open(os.path.join(outdir, "genome_lengths.out"), "w") as f:
        gl = art.genome_lengths
        for i in range(len(rid)):
            f.write(f"{int(rid[i])}\t{int(gl[i])}\n")


def save_index(art: BuildArtifacts, outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    if art.unique_index is not None:
        save_flat_index(os.path.join(outdir, "index_u.npz"), art.unique_index)
    if art.doubly_index is not None:
        save_flat_index(os.path.join(outdir, "index_d.npz"), art.doubly_index)
    write_meta_outputs(art, outdir)
