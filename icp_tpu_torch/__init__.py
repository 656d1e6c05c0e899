"""icp_tpu_torch — the ICP engine of ``icp_tpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``icp_tpu`` is the reference this package is held against;
the two share their config strings and layouts.  Importing this package
needs neither JAX nor a CUDA toolkit: the kernels are built by ``nvcc`` on
first use (``kernels/_build.py``), and CPU tensors take each kernel's plain
PyTorch version.
"""

from icp_tpu_torch.config import GRID_AUTO_THRESHOLD, ICPConfig
from icp_tpu_torch.engine.batched import batch_pairs, icp_batched, register_chain_batched
from icp_tpu_torch.engine.global_reg import (
    GlobalRegResult,
    compatibility_scores,
    global_register,
    match_features,
    ransac_alignment,
)
from icp_tpu_torch.engine.icp import (
    ICPGuardError,
    ICPResult,
    ICPTrace,
    icp,
    icp_fixed_iters,
    icp_resumable,
    icp_step,
)
from icp_tpu_torch.engine.gicp import disk_covariances, icp_generalized
from icp_tpu_torch.engine.point_to_plane import icp_point_to_plane
from icp_tpu_torch.engine.symmetric import icp_symmetric
from icp_tpu_torch.io.csv import load_matrix, write_matrix
from icp_tpu_torch.kernels.nn_bf16 import closest_point_indices_bf16
from icp_tpu_torch.ops.alignment import (
    AlignmentStats,
    Similarity,
    alignment_from_stats,
    compute_alignment_stats,
    find_alignment,
)
from icp_tpu_torch.ops.distance import closest_point_indices
from icp_tpu_torch.ops.fpfh import fpfh_features
from icp_tpu_torch.ops.normals import estimate_normals, orient_normals
from icp_tpu_torch.ops.padding import auto_quantum, pad_to_bucket
from icp_tpu_torch.ops.transform import (
    apply_similarity,
    compose,
    identity_similarity,
    inverse,
)
from icp_tpu_torch.ops.voxel import voxel_downsample, voxel_downsample_np
from icp_tpu_torch.slam.closure import (
    ClosureCandidate,
    chain_edges_from_pairs,
    detect_loop_closures,
    overlap_fraction,
    refine_closures,
    verified_inlier_fraction,
)
from icp_tpu_torch.slam.pairwise import (
    PairwiseResult,
    chain_to_world_poses,
    initialize_pca,
    register_chain,
    register_pair,
)
from icp_tpu_torch.slam.pose_graph import PoseEdge, bundle_adjust, optimize_pose_graph

__version__ = "0.1.0"

__all__ = [
    "GRID_AUTO_THRESHOLD",
    "ICPConfig",
    "ICPResult",
    "ICPTrace",
    "ICPGuardError",
    "icp",
    "icp_fixed_iters",
    "icp_resumable",
    "icp_step",
    "icp_point_to_plane",
    "icp_symmetric",
    "icp_generalized",
    "disk_covariances",
    "closest_point_indices_bf16",
    "estimate_normals",
    "orient_normals",
    "auto_quantum",
    "pad_to_bucket",
    "load_matrix",
    "write_matrix",
    "AlignmentStats",
    "Similarity",
    "alignment_from_stats",
    "compute_alignment_stats",
    "find_alignment",
    "closest_point_indices",
    "apply_similarity",
    "compose",
    "identity_similarity",
    "inverse",
    "icp_batched",
    "batch_pairs",
    "register_chain_batched",
    "voxel_downsample",
    "voxel_downsample_np",
    "fpfh_features",
    "GlobalRegResult",
    "match_features",
    "compatibility_scores",
    "ransac_alignment",
    "global_register",
    "PairwiseResult",
    "initialize_pca",
    "register_pair",
    "register_chain",
    "chain_to_world_poses",
    "PoseEdge",
    "optimize_pose_graph",
    "bundle_adjust",
    "ClosureCandidate",
    "detect_loop_closures",
    "overlap_fraction",
    "verified_inlier_fraction",
    "chain_edges_from_pairs",
    "refine_closures",
]
