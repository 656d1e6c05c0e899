"""The port's roofline (``icp_tpu_torch/bench/roofline.py``): the H100's
data-sheet spec keyed on the card's name, no utilization off it, the
bounds pinned to the kernel table's values in ``PERF.md`` §6, and
``chip_smoke.py`` on the same formula."""

import os

import pytest

from icp_tpu_torch.bench import roofline
from icp_tpu_torch.bench.roofline import (
    PAIR_OPS,
    bf16_bound,
    bound,
    chip_spec,
    fused_iteration_bound_s,
    fused_ops,
    iteration_mfu_pct,
    mfu_fields,
    nn_bound_pairs_per_s,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COW = 2903
HORSE = 48485
H100_NAME = "NVIDIA H100 80GB HBM3"


def test_h100_spec_by_device_name_and_none_elsewhere():
    spec = chip_spec(H100_NAME)
    assert spec is not None
    assert (spec.f32_ops_per_s, spec.bf16_ops_per_s, spec.hbm_bytes_per_s) == (
        67e12, 989e12, 3.35e12)
    for other in ("cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert chip_spec(other) is None
    assert mfu_fields(None, "closest_pallas", 1.0, 1.0, 1.0) == {}
    assert iteration_mfu_pct(None, COW, COW, 42e-6) is None


@pytest.mark.parametrize("label, got, want, digits", [
    ("K1 at cow", lambda: bound(PAIR_OPS * COW * COW, 12 * COW + 12 * COW + 4 * COW), 0.0010, 4),
    ("K1 on the 1M seed", lambda: bound(PAIR_OPS * 1_015_808 * 62_500, 0), 7.5807, 4),
    ("K3 at cow", lambda: bound(fused_ops(COW, COW), 12 * COW + 16 * COW), 0.00075, 5),
    ("K9 at horse", lambda: bf16_bound(HORSE * HORSE, 40 * HORSE), 0.1053, 4),
    ("K11 at horse", lambda: bound(PAIR_OPS * HORSE * HORSE, 12 * HORSE + 12 * HORSE
                                   + 4 * HORSE + 12 * HORSE), 0.2807, 4),
])
def test_bounds_pinned_to_the_kernel_table(label, got, want, digits):
    ms, by = got()
    assert round(ms, digits) == want, label
    assert by == "operations", label


def test_fused_iteration_bound_is_k3s_and_scales_with_the_model():
    b = fused_iteration_bound_s(chip_spec(H100_NAME), COW, COW)
    assert set(b) == {"apply_s", "fold_s", "extract_s", "stats_s", "solve_s", "total_s"}
    assert b["total_s"] == pytest.approx(
        sum(v for k, v in b.items() if k != "total_s"), rel=1e-15)
    assert b["total_s"] * 1e3 == pytest.approx(bound(fused_ops(COW, COW), 0)[0], rel=1e-12)
    assert round(b["total_s"] * 1e3, 5) == 0.00075
    b2 = fused_iteration_bound_s(chip_spec(H100_NAME), COW, 2 * COW)
    assert b2["fold_s"] == pytest.approx(2 * b["fold_s"], rel=1e-12)
    for k in ("apply_s", "extract_s", "stats_s", "solve_s"):
        assert b2[k] == b[k], k
    # K3 at cow: 19.3 us on the device, more by events: a few percent
    assert 3.0 < iteration_mfu_pct(chip_spec(H100_NAME), COW, COW, 19.3e-6) < 5.0


def test_nn_bounds_and_row_fields():
    spec = chip_spec(H100_NAME)
    assert nn_bound_pairs_per_s(spec, "closest_pallas") == 67e12 / 8
    assert nn_bound_pairs_per_s(spec, "closest_fused") == 67e12 / 6
    assert nn_bound_pairs_per_s(spec, "closest_bf16") == pytest.approx(67e12 / 3)
    assert nn_bound_pairs_per_s(spec, "closest_grid") is None
    row = mfu_fields(spec, "closest_pallas", 0.5 * 67e12 / 8, None, 1e-3)
    assert row["mfu_pct"] == 50.0 and "hbm_util_pct" not in row
    row = mfu_fields(spec, "err_compute", None, 2 * COW * 3 * 4, 1e-6)
    assert 0.0 < row["hbm_util_pct"] < 100.0 and "mfu_pct" not in row
    assert not any("vpu" in k for k in row)


def test_chip_smoke_bounds_come_from_the_roofline():
    """One formula: ``chip_smoke.py`` imports the bound and its counts and
    defines no peak of its own."""
    import chip_smoke

    assert chip_smoke.bound is roofline.bound
    assert chip_smoke.bf16_bound is roofline.bf16_bound
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    for literal in ("67e12", "989e12", "3.35e12", "def bound(", "def slower("):
        assert literal not in src, literal
