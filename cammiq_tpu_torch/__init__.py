"""CAMMiQ in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``cammiq_tpu`` (the JAX reference, unchanged) for one NVIDIA H100:
the query path in all three modes, the device index build, and the JAX
package's host build engines and cross-host build.  The package stands
alone: it imports nothing of ``cammiq_tpu`` and never imports jax.

The device side:

  device.py        explicit device selection (CUDA asked for and absent
                   raises; there is no silent CPU run)
  u32.py           uint32 wraparound arithmetic for the plain versions
  kernels/         the ten CUDA kernels (sources in csrc/), each beside
                   its plain PyTorch version, built with nvcc at first use
  query/           merged index on the device, the bloom -> cuckoo probe
                   join and its match assembly (one match_assemble launch
                   a batch), the gather engine, the case analysis (one
                   case_count launch a batch), the query session
  ops/, index/     the device index build (index/builder.py, the default
                   engine): suffix array, LCP, GSA, LCP0, OCC, MU on the
                   device; selection on the host
  models/quant.py  the quantification QP solver on torch tensors (each
                   FISTA chunk one quant_fista launch on the card)
  cli.py           ``python -m cammiq_tpu_torch.cli`` (--device, then the
                   cammiq_tpu CLI flags)

The host build engines (``build_index(engine="native"|"numpy")``, no
device) and the cross-host build are host code in the JAX package too, and
are copies of it:

  native.py            binds all of native/ (SA-IS, the bounded sort, the
                       narrow-dtype sweeps, the selection sweep, the FASTQ
                       parser), built into _build/ at first use
  ops/sa_host.py       suffix_array_numpy, inverse_permutation
  ops/lcp_host.py      LCP_CLAMP, lcp_from_sa_numpy, lcp_kasai_scalar
  ops/scans_host.py    the numpy segmented scans
  index/unique_host.py the numpy uniqueness stages (OCC_SATURATE,
                       DoublyResult, occ_unique, occ_doubly, ...)
  index/staging.py     StageStore, staged: resumable on-disk stages
  index/chunked.py     the chunk-carried sweeps of the cross-host build
  parallel/dist_build.py
                       dist_bounded_sa, dist_build_index (workers P0-P5)
  io/fasta.py          build_corpus_streaming among the corpus readers

None of these imports torch, so the cross-host build's worker processes
load numpy only.  The other host code the port needs is copied from the
JAX package too, module by module at the same place in the tree, each copy
naming its source in its docstring: config.py, io/, utils/timing.py,
ops/packing.py, index/{sparsify,table,artifact}.py (artifact.py with
ensure_cuckoo and its command), index/refcompat.py (the reference
binary's .bin1/.bin2 index files, read and written), query/merged.py (the
numpy builders of the merged index), models/{ident,output}.py and the
problem builder of models/quant.py, the CLI's parser, tools/simulate.py,
tools/{preprocess,download}.py (the genome-database tools that write
genome_map.out), tools/benchdata.py (the bench's genome generator and
read sampler), and version.py.  With them the port does everything the
JAX package does; only utils/jitcache.py, JAX's compilation cache, has no
counterpart.
"""

from .version import __version__

__all__ = ["__version__"]
