"""``python3 -m regbench``: see ``regbench/run.py``."""

import time

_T0 = time.perf_counter()  # process start, as near as Python allows

import sys  # noqa: E402

from regbench.run import main  # noqa: E402

sys.exit(main(t0=_T0))
