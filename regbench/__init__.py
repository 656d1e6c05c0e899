"""regbench: the benchmark of ``icp_tpu_torch`` on NVIDIA cards.

``python3 -m regbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` from the root of a checkout (``run.py``).  Everything a cell reads
is a file found by its name in ``BENCHMARK.json``: configurations in
``configs/``, traffic mixes in ``traffic/``, limits in ``limits/``, metric
readers in ``metrics/``; the plain reference is ``reference/``.  The
readings the limits were set from, and the planted faults, come from
``python3 -m regbench.control`` (``control.py``, ``faults.py``).
"""
