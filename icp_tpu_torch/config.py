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
# every engine, as in JAX).  JAX's TPU value is 4,096.
GRID_AUTO_THRESHOLD = 65536


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
      grid_scene_tile / grid_model_tile: target kd tile sizes of the grid path.
      grid_max_candidates: candidate-tile capacity per scene tile; a tile
        with more candidates folds every model tile (exact either way).
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
    grid_scene_tile: int = 256
    grid_model_tile: int = 1024
    grid_max_candidates: int = 16

    def resolved_solver(self, backend: str) -> str:
        if self.solver != "auto":
            return self.solver
        return "qcp_fused" if backend == "cuda" else "eigh"

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
