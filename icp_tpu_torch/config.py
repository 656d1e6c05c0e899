"""Configuration of the PyTorch/CUDA ICP engine.

Mirror of ``icp_tpu/config.py``: one ``ICPConfig`` means the same in both
packages.  The config strings are the JAX package's: ``nn_method="pallas"``
selects this package's dense NN kernel (``kernels/nn_dense.py``),
``nn_method="grid"`` the kd-tile work-list kernel (``kernels/nn_grid.py``),
and ``solver="qcp_fused"`` the scalar-solve kernel (``kernels/qcp.py``).
Where the JAX package resolves ``"auto"`` for ``"tpu"``, this one resolves it
for ``"cuda"``, at the card's own threshold; on ``"cpu"`` both resolve to
the plain ``bcast``/``eigh`` paths at every size.
"""

from __future__ import annotations

import dataclasses

import torch

# Smallest cloud (max of model/scene rows) at which ``nn_method="auto"``
# takes the kd-grid engine on the card; only ``"cuda"`` reads it.  Measured
# on an NVIDIA H100 80GB HBM3 at 700 W by ``scripts/dispatch_sweep.py``
# (``perf_h100/dispatch_sweep.jsonl``): the point-to-point dense loop (K3)
# is faster than the grid's at every size up to 48,485 rows and slower
# from 65,536 (the point-to-plane K1 loop from 131,072: one size serves
# every engine, as in JAX).  Re-checked with the card's grid sizes below
# (``perf_h100/grid_sweep.jsonl``): K3 still faster beyond the spread at
# 48,485, the two within the spread at 65,536, the grid beyond it from
# 131,072, so it stays.  JAX's TPU value is 4,096.
GRID_AUTO_THRESHOLD = 65536

# The grid path's sizes, (kd scene tile, kd model tile, candidate capacity):
# what ``ICPConfig``'s ``grid_scene_tile``, ``grid_model_tile`` and
# ``grid_max_candidates`` mean when they are None (K4's), and the normals'
# kNN sizes where ``ops/normals.knn_indices`` is given none (K7's: smaller
# query tiles, as in JAX, since the cull bound is a per-query-tile maximum,
# tight only over few queries).  On the CPU the JAX package's (TPU)
# values, so the plain versions tile and sum as JAX does.  On the card as
# ``scripts/dispatch_sweep.py --sections grid`` measured them (NVIDIA H100
# 80GB HBM3, 700 W; ``perf_h100/grid_sweep.jsonl``), on the 1M pair with
# the answers held: K4's capacity 128 (at 16, 126 of 4,096 scene tiles fold
# every model tile: 5.75 -> 3.28 ms an iteration; 64-256 within the
# spread), model tile 512 (3.24 -> 3.00), scene tile 256 kept (128 within
# the spread, 64 and 512-1,024 slower); K7's capacity 256 and model tile
# 512, query tile 64 kept (the 1M kNN 28.6 -> 20.4 ms a call).
GRID_SIZES = (256, 1024, 16)
GRID_SIZES_CUDA = (256, 512, 128)
KNN_GRID_SIZES = (64, 256, 32)
KNN_GRID_SIZES_CUDA = (64, 512, 256)


def grid_sizes(backend, scene_tile=None, model_tile=None, max_candidates=None, *,
               knn: bool = False) -> tuple:
    """(scene tile, model tile, capacity) of the grid path (``knn``: of the
    normals' kNN) on ``backend`` (``"cuda"``, ``"cpu"`` or a
    ``torch.device``): each size the caller gives as it is, each None as
    the backend's value."""
    kind = backend.type if isinstance(backend, torch.device) else backend
    if knn:
        base = KNN_GRID_SIZES_CUDA if kind == "cuda" else KNN_GRID_SIZES
    else:
        base = GRID_SIZES_CUDA if kind == "cuda" else GRID_SIZES
    return tuple(b if v is None else v for b, v in zip(base, (scene_tile, model_tile,
                                                              max_candidates)))


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """All tunables of the ICP engine (fields as in ``icp_tpu.ICPConfig``).

    Attributes:
      max_iter: maximum outer iterations (reference: argv[3]).
      threshold: convergence threshold on the reported per-iteration error.
      dtype: dtype of the point coordinates.  The kernels work in float32
        coordinates and accumulate the alignment sums in float64.
      reference_compat: report the reference's ~2x-MSE error metric (QUIRK-1)
        instead of the plain MSE.
      solver: ``"eigh"``, ``"qcp"``, ``"kabsch"``, ``"qcp_fused"`` (the
        scalar-solve kernel) or ``"auto"``.
      nn_method: ``"bcast"``, ``"matmul"``, ``"pallas"`` (dense kernel),
        ``"grid"`` (kd-tile kernel), ``"bf16"`` (the approximate bf16
        prefilter K9 with an exact recheck of the winner, for the dense
        loops; ``"auto"`` never picks it) or ``"auto"``.
      scene_tile / model_tile: the JAX kernels' tile sizes, kept so one
        config means the same in both packages; the CUDA kernels choose
        their own block shapes and do not read them.
      validate_inputs: enforce the reference's equal-count restriction.
      with_scale: estimate the similarity scale (False: rigid).
      trim_fraction: trimmed ICP: the fraction of correspondences, the
        farthest by squared distance, left out of each iteration (0: none).
      grid_scene_tile / grid_model_tile: target kd tile sizes of the grid
        path; None: the device's (``GRID_SIZES``: JAX's 256 / 1,024 on the
        CPU; ``GRID_SIZES_CUDA``: 256 / 512 on the card).
      grid_max_candidates: candidate-tile capacity per scene tile; a tile
        with more candidates folds every model tile (exact either way);
        None: the device's (JAX's 16 on the CPU, 128 on the card).
    """

    max_iter: int = 200
    threshold: float = 1e-5
    dtype: torch.dtype = torch.float32
    reference_compat: bool = True
    solver: str = "auto"
    nn_method: str = "auto"
    scene_tile: int = 256
    model_tile: int = 4096
    validate_inputs: bool = True
    with_scale: bool = True
    trim_fraction: float = 0.0
    grid_scene_tile: int | None = None
    grid_model_tile: int | None = None
    grid_max_candidates: int | None = None

    def resolved_solver(self, backend: str) -> str:
        if self.solver != "auto":
            return self.solver
        return "qcp_fused" if backend == "cuda" else "eigh"

    def resolved_grid_sizes(self, backend) -> tuple:
        """(scene tile, model tile, capacity) of the grid path on
        ``backend``: the fields given, the device's sizes for those left
        None (``grid_sizes``)."""
        return grid_sizes(backend, self.grid_scene_tile, self.grid_model_tile,
                          self.grid_max_candidates)

    def resolved_nn_method(self, backend: str,
                           n_points: int | None = None) -> str:
        """Resolve ``"auto"``: on ``"cuda"`` the dense kernel below
        ``GRID_AUTO_THRESHOLD`` points and the grid kernel at or above it;
        ``bcast`` elsewhere."""
        if self.nn_method != "auto":
            return self.nn_method
        if backend == "cuda":
            if n_points is not None and n_points >= GRID_AUTO_THRESHOLD:
                return "grid"
            return "pallas"
        return "bcast"
