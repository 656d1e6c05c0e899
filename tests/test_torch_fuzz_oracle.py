"""Seeded property sweep of the port against ``tests/oracle.py``.

The port's counterpart of ``tests/test_fuzz_oracle.py``: the same nine
clouds (random volumetric ones of 4 to 201 points, duplicated points with
exact distance ties, coplanar and near-collinear clouds, coordinates of
~1e3), each moved by a seeded rigid or similarity transform, registered by
the port's ``icp`` on the CPU in float64 (``solver="eigh"``,
``nn_method="bcast"``, ``trace=True``) and held to the oracle's error trace
and output cloud at that file's tolerances.  Each case's seed is
``zlib.crc32`` of its name, stable across processes.
"""

import zlib

import numpy as np
import pytest
import torch

from icp_tpu_torch import ICPConfig, icp
from tests import oracle

MAX_ITER = 25


def _rigid(rng, scale=False):
    a, b, c = rng.uniform(-0.4, 0.4, 3)

    def rot(theta, i, j):
        R = np.eye(3)
        R[i, i] = R[j, j] = np.cos(theta)
        R[i, j], R[j, i] = -np.sin(theta), np.sin(theta)
        return R

    R = rot(a, 0, 1) @ rot(b, 1, 2) @ rot(c, 0, 2)
    s = rng.uniform(0.7, 1.4) if scale else 1.0
    t = rng.uniform(-0.5, 0.5, 3)
    return s, R, t


def _cases():
    rng = np.random.default_rng(20260820)
    cases = []
    for n in (4, 5, 17, 64, 201):
        cases.append(("random", rng.standard_normal((n, 3))))
    base = rng.standard_normal((40, 3))
    cases.append(("duplicates", np.concatenate([base, base[:20], base[:7]])))
    flat = rng.standard_normal((90, 3))
    flat[:, 2] = 0.0
    cases.append(("coplanar", flat))
    line = np.linspace(0.0, 1.0, 60)[:, None] * np.array([1.0, 2.0, -0.5])
    cases.append(("near_collinear", line + 1e-4 * rng.standard_normal((60, 3))))
    cases.append(("big_scale", 1e3 * rng.standard_normal((50, 3))))
    return cases


CASES = _cases()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{name}-{len(m)}" for name, m in CASES])
def test_port_trace_matches_oracle(case):
    name, model = CASES[case]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    s, R, t = _rigid(rng, scale=(name == "random"))
    scene = (model @ (s * R).T) + t
    want_p, want_errs = oracle.icp(model, scene, MAX_ITER)

    tr = icp(model, scene,
             ICPConfig(max_iter=MAX_ITER, dtype=torch.float64, solver="eigh",
                       nn_method="bcast", validate_inputs=False),
             trace=True, device="cpu")
    got_errs = tr.errs[: int(tr.result.iters)].numpy()
    want = np.asarray(want_errs)
    assert len(got_errs) == len(want), (name, got_errs, want)
    # converged errors are float64 rounding dust proportional to the
    # squared coordinate scale: the contract is trace parity
    coord = float(np.max(np.abs(model))) + 1.0
    np.testing.assert_allclose(got_errs, want, rtol=1e-6,
                               atol=1e-28 * coord * coord, err_msg=name)
    np.testing.assert_allclose(tr.result.points.numpy(), want_p,
                               rtol=1e-6, atol=1e-9 * coord, err_msg=name)
