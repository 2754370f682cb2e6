"""The DCP cells' reader of the same spans (``eval_ms.train.py``), read
alike in the RPM-Net cell."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "eval_ms.train.py"))["read"]
