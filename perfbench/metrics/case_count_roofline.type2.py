"""``case_count_roofline``'s reader (``case_count_roofline.py``) in a cell that reports
``device_ms_per_mread`` in place of ``reads_per_s``."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "case_count_roofline.py"))["read"]
