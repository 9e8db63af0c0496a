"""CAMMiQ in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``cammiq_tpu`` (the JAX reference, unchanged) for one NVIDIA H100:
the query path in all three modes and the device index build.  The package
stands alone: it imports nothing of ``cammiq_tpu`` and never imports jax.

The device side:

  device.py        explicit device selection (CUDA asked for and absent
                   raises; there is no silent CPU run)
  u32.py           uint32 wraparound arithmetic for the plain versions
  kernels/         the five CUDA kernels (sources in csrc/), each beside
                   its plain PyTorch version, built with nvcc at first use
  query/           merged index on the device, the bloom -> cuckoo probe
                   join, case analysis, the query session (sc mode too)
  ops/, index/     the device index build: suffix array, LCP, GSA, LCP0,
                   OCC, MU on the device; selection on the host
  models/quant.py  the quantification QP solver on torch tensors
  cli.py           ``python -m cammiq_tpu_torch.cli`` (--device, then the
                   cammiq_tpu CLI flags)

The host code it needs is copied from the JAX package, module by module at
the same place in the tree, each copy naming its source in its docstring:
config.py, io/, utils/timing.py, ops/packing.py,
index/{sparsify,table,artifact}.py, query/merged.py (the numpy builders of
the merged index), models/{ident,output}.py and the problem builder of
models/quant.py, the CLI's parser, tools/simulate.py, and
tools/benchdata.py (the bench's genome generator and read sampler).
native.py binds native/'s selection sweep and FASTQ parser, built into
_build/ at first use.
"""
