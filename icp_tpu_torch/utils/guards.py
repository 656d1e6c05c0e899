"""Instrumented failure location (port of ``icp_tpu/utils/guards.py``).

``icp(guard="device")`` detects a failing run (``engine/icp.py``);
``checked_icp_step`` locates it.  JAX's runs one step under ``checkify``
with its float and index checks; this one runs one ``icp_step`` under a
``TorchDispatchMode`` that looks at every ATen op: it names the first op
whose floating output holds a NaN (as ``checkify``'s NaN check) or an
infinity that none of its inputs held, and the first gather whose index is
out of range, which it clamps so the step runs on as JAX's clamped gather
does.  Ops that only make a buffer (``empty``, ``full``, ``fill``...) are
not values computed from the data and are not checked.  A debugging tool,
many times slower than the step.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from icp_tpu_torch.utils.precision import in_full_float32

# gathers whose index argument is checked: op -> (source position, index
# position, dimension position or the fixed dimension)
_GATHERS = {
    torch.ops.aten.index_select.default: (0, 2, 1),
    torch.ops.aten.gather.default: (0, 2, 1),
}


# ops that make a buffer rather than compute from the data
_BUFFERS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "full",
            "full_like", "new_full", "fill", "fill_", "scalar_tensor", "zeros", "zeros_like",
            "ones", "ones_like", "new_zeros", "new_ones"}


def _has(tensors, test) -> bool:
    return any(t.is_floating_point() and bool(test(t).any()) for t in tensors)


class _Checks(TorchDispatchMode):
    """Records the first failing op's message in ``self.msg``."""

    def __init__(self):
        super().__init__()
        self.msg = None

    def _fail(self, msg: str) -> None:
        if self.msg is None:
            self.msg = msg

    def _check_index(self, func, args):
        """Clamped copies of out-of-range gather indices, with a message."""
        args = list(args)
        if func is torch.ops.aten.index.Tensor:
            src, indices = args[0], list(args[1])
            for d, ix in enumerate(indices):
                if ix is not None and ix.numel() and ix.dtype in (torch.int64, torch.int32):
                    n = src.shape[d]
                    if bool(((ix < -n) | (ix >= n)).any()):
                        self._fail(f"out-of-bounds index in {func} (dimension {d}, size {n})")
                        indices[d] = ix.clamp(-n, n - 1)
            args[1] = indices
        elif func in _GATHERS:
            s, i, d = _GATHERS[func]
            src, ix, dim = args[s], args[i], args[d]
            n = src.shape[dim] if src.ndim else 1
            if ix.numel() and bool(((ix < -n) | (ix >= n)).any()):
                self._fail(f"out-of-bounds index in {func} (dimension {dim}, size {n})")
                args[i] = ix.clamp(-n, n - 1)
        return args

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        args = self._check_index(func, args)
        out = func(*args, **kwargs)
        if self.msg is None and func.overloadpacket.__name__ not in _BUFFERS:
            outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
            if _has(outs, torch.isnan):
                self._fail(f"nan generated by {func}")
            elif _has(outs, torch.isinf):
                ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
                if not _has(ins, torch.isinf):
                    self._fail(f"inf generated by {func}")
        return out


@in_full_float32
def checked_icp_step(scene, model, *, solver: str = "eigh", nn_method: str = "bcast",
                     with_scale: bool = True, device=None):
    """Run ONE ICP iteration under the checks.  Returns ``(message or None,
    (p_new, sim, err))``: the message names the first op that produced a
    NaN/Inf or indexed out of range."""
    from icp_tpu_torch.engine.icp import as_points, icp_step

    m = as_points(model, torch.float32, device)
    p = as_points(scene, torch.float32, m.device)
    checks = _Checks()
    with checks:
        out = icp_step(p, m, solver=solver, nn_method=nn_method, with_scale=with_scale,
                       reference_compat=True)
    return checks.msg, out
