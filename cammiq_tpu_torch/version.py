"""The package version: a copy of ``cammiq_tpu/version.py``."""

__version__ = "0.1.0"
