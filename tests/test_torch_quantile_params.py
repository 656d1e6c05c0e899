"""``histogram_quantile``'s ``rounds`` and ``bins`` against JAX's
(``icp_tpu/ops/quantile.py``).

They set how finely the trim threshold tau is bracketed, so other values
give another tau: for the same values and mask it must be bit-equal to
JAX's, in float32 and float64.  The defaults (2 rounds of 32 bins) must
give the call without them bit for bit, with the same operations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from icp_tpu.ops.quantile import histogram_quantile as j_quantile
from icp_tpu_torch.ops.quantile import histogram_quantile

QS = (0.5, 0.9, 0.999)


def _values(seed, n, dtype):
    """Gamma-distributed squared distances over six decades, every other
    set rounded to quarters (ties and values on the bin edges), and a 0/1
    mask."""
    rng = np.random.default_rng(seed)
    d2 = rng.gamma(2.0, 1.0, n) * 10.0 ** rng.uniform(-6, 2)
    if seed % 2 == 0:
        d2 = np.round(d2 * 4) / 4
    return d2.astype(dtype), (rng.random(n) > 0.3).astype(dtype)


@pytest.mark.parametrize("rounds,bins", [(1, 8), (3, 32), (2, 64)])
@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_rounds_and_bins_bit_equal_to_jax(dtype, masked, rounds, bins):
    for seed in range(4):  # two shapes: JAX compiles once for each
        d2, w = _values(seed, (300, 2051)[seed % 2], dtype)
        for q in QS:
            want = np.asarray(j_quantile(jnp.asarray(d2), q, jnp.asarray(w) if masked else None,
                                         rounds=rounds, bins=bins))
            got = histogram_quantile(torch.tensor(d2), q, torch.tensor(w) if masked else None,
                                     rounds=rounds, bins=bins).numpy()
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (seed, q)


def test_other_rounds_and_bins_change_tau():
    """The parameters reach the answer: one round of 8 bins brackets more
    coarsely than the default, and never trims more than asked."""
    d2, _ = _values(1, 2051, np.float64)
    t = torch.tensor(d2)
    for q in QS:
        coarse = float(histogram_quantile(t, q, rounds=1, bins=8))
        fine = float(histogram_quantile(t, q))
        assert coarse >= fine
        assert float((t <= coarse).double().mean()) >= q
    assert any(float(histogram_quantile(t, q, rounds=1, bins=8)) != float(histogram_quantile(t, q))
               for q in QS)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_defaults_are_the_call_without_keywords(dtype, masked):
    """``rounds=2, bins=32`` is the call without them: tau bit for bit and
    the same operations in the same order (so no more launches on the
    card)."""
    d2, w = _values(2, 1000, np.float64)
    t = torch.tensor(d2, dtype=dtype)
    wt = torch.tensor(w, dtype=dtype) if masked else None
    histogram_quantile(t, 0.9, wt)  # the cached constants, made once
    with _Ops() as plain:
        want = histogram_quantile(t, 0.9, wt)
    with _Ops() as keyed:
        got = histogram_quantile(t, 0.9, wt, rounds=2, bins=32)
    assert got.dtype == want.dtype and got.numpy().tobytes() == want.numpy().tobytes()
    assert keyed.ops == plain.ops
