"""The card's roofline: least times and utilization shares from its data
sheet (port of ``icp_tpu/bench/roofline.py``).

One formula serves the harness rows here and every kernel line of
``chip_smoke.py``: ``bound(ops, nbytes)`` is the least time the card could
take for a function, the larger of its operations over the float32 peak
and its bytes (each input read once, each output written once) over the
memory rate.  The operation counts are read off the CUDA sources
(``icp_tpu_torch/csrc/``), cited where each is defined.

Chip model (NVIDIA's H100 SXM data sheet, dense rates, at the full power
limit of 700 W; a card set below it runs slower under load, so every
measurement names its card and power limit):

  * float32 outside the tensor cores: 67e12 operations/s (an FMA is two);
  * bf16 on the tensor cores, dense: 989e12 operations/s (K9's cross term);
  * HBM3: 3.35e12 bytes/s.

A share is measured rate over bound rate: a compute-bound kernel nears
100% with a small memory share, a memory-bound one the reverse.  A share
above 100% means the count is wrong (the bound is a least time), never
that the card ran above its data sheet.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str
    f32_ops_per_s: float  # float32 outside the tensor cores
    bf16_ops_per_s: float  # bf16 on the tensor cores, dense
    hbm_bytes_per_s: float


H100 = ChipSpec(name="H100 SXM", f32_ops_per_s=67e12, bf16_ops_per_s=989e12,
                hbm_bytes_per_s=3.35e12)

# torch.cuda.get_device_name() -> spec.  Any other name (the CPU, another
# card) has none, and the callers then print no utilization field.
_SPECS = {"NVIDIA H100 80GB HBM3": H100}

PEAK_FLOPS = H100.f32_ops_per_s
PEAK_BF16 = H100.bf16_ops_per_s
PEAK_BYTES = H100.hbm_bytes_per_s

# Operations counted off the kernels (float32 unless named):
#   PAIR_OPS: a diff-squares distance, 3 sub + 3 mul + 2 add
#     (common.cuh sqdist_rn), the exact folds K1, K4, K6, K7, K8, and K10 as
#     the kernel table counts it; the compare and select are not counted.
#   FUSED_PAIR_OPS: K3's expansion-form distance, 3 mul + 3 add a pair on
#     the pre-scaled (-2m, |m|^2) rows (common.cuh expdist_rn).
#   STEP_OPS, STEP_ROW_OPS: K2's float64 solve, composition and loop test
#     (qcp_warp.cuh), ~600 dependent operations, plus 18 to add one row of
#     the Horn sums.
#   ROTATION_OPS: K5's float64 QCP rotation (qcp.cu), ~500 operations.
#   BF16_PAIR_OPS, BF16_F32_PAIR_OPS: K9's cross term as a bf16 product on
#     the tensor cores (K padded to 16: 32 operations a pair), beside the
#     float32 add of the norm and the fold's two compares (nn_bf16.cu).
PAIR_OPS = 8
FUSED_PAIR_OPS = 6
STEP_OPS = 600
STEP_ROW_OPS = 18
ROTATION_OPS = 500
BF16_PAIR_OPS = 32
BF16_F32_PAIR_OPS = 3


def chip_spec(device_name: str) -> ChipSpec | None:
    """The spec of the card ``torch.cuda.get_device_name()`` names, or None
    (the CPU, an unknown card): callers then leave utilization out rather
    than make it up."""
    return _SPECS.get(device_name)


def slower(ops_ms: float, bytes_ms: float):
    """(the larger of the two, "operations" or "bytes")."""
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bound(ops: float, nbytes: float, spec: ChipSpec = H100):
    """(least ms, what bounds it): ``ops`` float32 operations over the float32
    peak against ``nbytes`` over the memory rate."""
    return slower(ops / spec.f32_ops_per_s * 1e3, nbytes / spec.hbm_bytes_per_s * 1e3)


def fused_ops(n_scene: int, n_model: int) -> int:
    """K3's operations for one iteration: the fold and K2's solve."""
    return FUSED_PAIR_OPS * n_scene * n_model + STEP_OPS


def step_ops(rows: int) -> int:
    """K2's operations on ``rows`` rows of Horn sums."""
    return STEP_OPS + STEP_ROW_OPS * rows


def bf16_bound(pairs: int, nbytes: float, spec: ChipSpec = H100):
    """K9's (least ms, what bounds it): the tensor cores' product and the
    float32 units' adds and compares run side by side, so the longer of the
    two, against the bytes."""
    ops_ms = max(BF16_PAIR_OPS * pairs / spec.bf16_ops_per_s,
                 BF16_F32_PAIR_OPS * pairs / spec.f32_ops_per_s) * 1e3
    return slower(ops_ms, nbytes / spec.hbm_bytes_per_s * 1e3)


# Operations a candidate pair of each harness NN row: K1 and the torch
# rows in diff-squares form (closest_bcast; closest_matmul's expansion
# form in one matmul and an argmin is counted alike, as JAX counts its two
# rows alike), K3 in expansion form.  closest_bf16 is K9's bound
# (``bf16_bound``); closest_grid has none: it prunes pairs by design.
_PAIR_OPS_OF = {
    "closest_pallas": PAIR_OPS,
    "closest_bcast": PAIR_OPS,
    "closest_matmul": PAIR_OPS,
    "closest_fused": FUSED_PAIR_OPS,
}


def nn_bound_pairs_per_s(spec: ChipSpec, op: str) -> float | None:
    """Candidate pairs a second the card's float32 pipe allows for ``op``
    (K9's: the slower of its tensor-core and float32 counts); None for an
    op with no count."""
    if op == "closest_bf16":
        return 1.0 / max(BF16_PAIR_OPS / spec.bf16_ops_per_s,
                         BF16_F32_PAIR_OPS / spec.f32_ops_per_s)
    ops = _PAIR_OPS_OF.get(op)
    return None if ops is None else spec.f32_ops_per_s / ops


def fused_iteration_bound_s(spec: ChipSpec, n_scene: int, n_model: int) -> dict:
    """Least seconds of one fused iteration (K3) at (n_scene, n_model), by
    component, as the kernel table counts K3 (``fused_ops``):

      * fold: ``FUSED_PAIR_OPS`` a pair over the float32 peak
        (icp_fused.cu's chunk loop, expdist_rn);
      * solve: K2's ``STEP_OPS`` in the last block (qcp_warp.cuh);
      * apply, extract, stats: 0.  K3 moves each scene point in registers
        (18 operations a point), takes the winner's row from its merge key
        (no extraction pass) and adds 17 float64 sums a point: O(n) work,
        0.3% of the fold at cow, not counted in the table's bound and so not
        here.  The keys are JAX's, so rows diff across the two packages.

    ``total_s`` is their sum and equals K3's bound in the kernel table.
    """
    fold_s = FUSED_PAIR_OPS * n_scene * n_model / spec.f32_ops_per_s
    solve_s = STEP_OPS / spec.f32_ops_per_s
    return dict(apply_s=0.0, fold_s=fold_s, extract_s=0.0, stats_s=0.0, solve_s=solve_s,
                total_s=fold_s + solve_s)


def iteration_mfu_pct(spec: ChipSpec | None, n_scene: int, n_model: int,
                      measured_iter_s: float) -> float | None:
    """Percent of the fused iteration's bound that a measured dense
    iteration reaches (None without a spec or a positive time).  Only a
    dense iteration (fused or pipeline) is graded so: a grid iteration does
    a fraction of the dense work by design."""
    if spec is None or measured_iter_s <= 0:
        return None
    bound_s = fused_iteration_bound_s(spec, n_scene, n_model)["total_s"]
    return round(100.0 * bound_s / measured_iter_s, 1)


def mfu_fields(spec: ChipSpec | None, op: str, pairs_per_s: float | None,
               bytes_per_call: float | None, time_s: float) -> dict:
    """Utilization fields of one harness row ({} without a spec).

    ``mfu_pct``: candidate pairs a second over the op's bound rate, for the
    ops with a count; ``hbm_util_pct``: the op's bytes a call over its time,
    over the memory rate, where its traffic is known."""
    if spec is None:
        return {}
    out: dict = {"roofline": spec.name}
    rate = nn_bound_pairs_per_s(spec, op) if pairs_per_s else None
    if rate:
        out["bound_pairs_per_s"] = rate
        out["mfu_pct"] = round(100.0 * pairs_per_s / rate, 1)
    if bytes_per_call:
        out["hbm_util_pct"] = round(100.0 * bytes_per_call / time_s / spec.hbm_bytes_per_s, 2)
    return out
