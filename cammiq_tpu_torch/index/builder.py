"""Device index build: the flow of the JAX device engine on a torch device.

Port of ``cammiq_tpu/index/builder.py:build_index(engine="jax")``
(119-253): suffix array, LCP, GSA, LCP0, OCC and MU run on the device;
the sparsified selection (``cammiq_tpu.index.sparsify.select_substrings``)
and the flat tables (``cammiq_tpu.index.table.build_flat_index``) run on
the host, imported.  The input is the same host ``Corpus`` the JAX package
takes, and the result is its ``BuildArtifacts``, stage timings included,
so ``save_index`` and ``write_meta_outputs`` apply unchanged.

Selection runs with ``engine="auto"``: the C++ sweep where the native
library is built (the host build's engine at scale), else the vectorised
numpy path.  The JAX device engine passes ``"fast"``; the engines give the
same output (``sparsify.py:95-99``), and the port's tests hold the whole
index to ``build_index(engine="jax")``.

Not ported: ``stage_dir`` (disk staging) and ``sa_hosts`` (the sharded
host suffix sort) of the JAX ``build_index``.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from cammiq_tpu.config import BuildConfig
from cammiq_tpu.index.builder import BuildArtifacts
from cammiq_tpu.index.sparsify import select_substrings
from cammiq_tpu.index.table import build_flat_index
from cammiq_tpu.io.fasta import Corpus
from cammiq_tpu.utils.timing import Timings, stage_timer

from ..device import resolve_device
from ..kernels.lcp_pairs import LCP_CLAMP, lcp_pairs
from ..ops.sa import suffix_array
from . import unique as uq


def _host(t: torch.Tensor, dtype=None) -> np.ndarray:
    """Device tensor -> numpy (narrowed on the device first, which cuts
    the transfer)."""
    return (t if dtype is None else t.to(dtype)).cpu().numpy()


def build_index(corpus: Corpus, cfg: BuildConfig, device="cuda",
                verbose: bool = False) -> BuildArtifacts:
    """Build the unique and/or doubly index (``cfg.mode``) of ``corpus``
    with the device stages on ``device``."""
    if cfg.occ_u8_wrap:
        raise ValueError("occ_u8_wrap (bit-parity mode) requires a host engine")
    dev = resolve_device(device)
    timings = Timings()
    n = corpus.n

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
        sa = suffix_array(text)
    with stage("computing LCP array"):
        lcp = lcp_pairs(text, sa, LCP_CLAMP)
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
