"""CAMMiQ query path in PyTorch with hand-written CUDA kernels for Hopper.

A port of ``cammiq_tpu`` (the JAX reference, unchanged) for one NVIDIA H100.
Host code that never touches a device - FASTQ/FASTA parsing, the index
build and artifact code, output writers, ``quant.build_problem`` - is
imported from ``cammiq_tpu``; this package holds the device side:

  device.py        explicit device selection (CUDA asked for and absent
                   raises; there is no silent CPU run)
  u32.py           uint32 wraparound arithmetic for the plain versions
  kernels/         the three CUDA kernels (sources in csrc/), each beside
                   its plain PyTorch version, built with nvcc at first use
  query/           merged index on the device, the bloom -> cuckoo probe
                   join, case analysis, the query session
  models/quant.py  the quantification QP solver on torch tensors
  cli.py           ``python -m cammiq_tpu_torch.cli`` (--device, then the
                   cammiq_tpu CLI flags)

This package never imports jax.
"""
