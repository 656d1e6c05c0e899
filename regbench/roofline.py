"""The card's peaks and the least time of each kernel the metrics grade.

Frozen here so that no later change to the program moves the yardstick.
Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full power limit
of 700 W (a card set below it runs slower under load, so every reading is
kept with its card and power limit).  Counts, from the kernels' inputs,
never from what a kernel chose to do:

* K1 (the exhaustive dense nearest-neighbour fold): 8 float32 operations a
  (scene, model) pair, a diff-squares distance (3 sub, 3 mul, 2 add);
* K3 (the fused iteration): 6 a pair, the expansion form on pre-scaled
  model rows, and 600 for the closed-form step in its last block;
* K4 and K7 (the pruned grid searches): bytes only, each input row read
  once and each output written once, so the count stays valid whatever
  the search prunes.
"""

from __future__ import annotations

F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = 12  # three float32 coordinates
INDEX_BYTES = 4  # an int32 index or a float32 distance

PAIR_OPS = 8
FUSED_PAIR_OPS = 6
STEP_OPS = 600


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds: the larger of ``ops`` over the float32 peak and
    ``nbytes`` over the memory rate."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def k1_bound_s(n: int, m: int) -> float:
    """One dense search of ``n`` scene rows among ``m`` model rows."""
    return bound_s(PAIR_OPS * n * m, ROW_BYTES * (n + m) + INDEX_BYTES * n)


def k3_bound_s(n: int, m: int) -> float:
    """One fused iteration: the fold and the step."""
    return bound_s(FUSED_PAIR_OPS * n * m + STEP_OPS, ROW_BYTES * (n + m))


def k4_bound_s(n: int, m: int, payload_cols: int = 0) -> float:
    """One grid search: scene and model rows (and ``payload_cols`` float32
    columns a model row) read once, an index and a distance a scene row
    written once."""
    return bound_s(0, ROW_BYTES * (n + m) + 4 * payload_cols * m + 2 * INDEX_BYTES * n)


def k7_bound_s(n: int, m: int, k: int) -> float:
    """One grid kNN: query and model rows read once, ``k`` indices a query
    row written once."""
    return bound_s(0, ROW_BYTES * (n + m) + INDEX_BYTES * k * n)
