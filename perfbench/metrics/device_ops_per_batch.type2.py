"""``device_ops_per_batch``'s reader (``device_ops_per_batch.py``) in a cell that reports
``device_ms_per_mread`` in place of ``reads_per_s``."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "device_ops_per_batch.py"))["read"]
