"""The plain references the benchmark holds the program's answers against;
nothing here imports the program.

A traffic mix names its reference: ``"reference": "<name>"`` is the module
``regbench/reference/<name>.py``, found by that name (``check.py``).  A
reference module defines one function::

    answer(model, scene, icp, kwargs, *, precision, device) -> icp.Answer

* ``model``, ``scene``: the request's two clouds, (M, 3) and (N, 3)
  float64 NumPy arrays (the benchmark's float32 rows, read as float64);
* ``icp``: the configuration's ``icp`` fields merged with the mix's
  (``max_iter``, ``threshold``, ``reference_compat``, ``trim_fraction``, ...);
* ``kwargs``: the mix's ``kwargs``, as the program's entry gets them;
* ``precision``: ``"float64"`` for the reference, ``"tf32"`` for the
  control, the same registration one precision below the port's float32
  (every product input rounded to TF32, the state kept in float32).  A
  reference has to give both;
* ``device``: where the exact nearest-neighbour search runs (``nn.py``).

It imports only NumPy, SciPy, torch and ``regbench.reference.*``, and
takes nothing that the program made.  The shared code is ``icp.py`` (the
loops, ``Answer``, the TF32 rounding) and ``nn.py`` (the search); neither
defines ``answer``, so neither is a reference.
"""
