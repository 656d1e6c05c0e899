"""Full float32 inside the package, whatever the caller set.

Every float32 matrix product that feeds an argmin or a solve (the apply of
a similarity, the Horn sums, the Gauss-Newton systems, the normals'
covariances) needs full float32: the JAX package pins
``Precision.HIGHEST`` op by op.  PyTorch instead reads one process-wide
setting, and a caller who ran ``torch.set_float32_matmul_precision("high")``
would put every such product through TF32 on the card (about 1e-3 relative
error a coordinate, an error floor near 1e-4 on cow).

``full_float32`` is the scoped guard the public entry points run under: it
sets the float32 matmul precision to ``"highest"`` on entry and restores
the caller's setting on exit, also when the body raises.  Nothing is set
when the package is imported.
"""

from __future__ import annotations

import contextlib
import functools

import torch


def _per_backend():
    """The per-backend float32 precision switches this torch has (newer
    releases keep one for cuBLAS and one for oneDNN beside the global
    setting); saved and restored as they were, so a caller who set one of
    them alone gets it back unchanged."""
    out = []
    for name in ("cuda", "mkldnn"):
        matmul = getattr(getattr(torch.backends, name, None), "matmul", None)
        if hasattr(matmul, "fp32_precision"):
            out.append(matmul)
    return out


@contextlib.contextmanager
def full_float32():
    """Run the body with float32 matmuls in full float32 (no TF32)."""
    prev = torch.get_float32_matmul_precision()
    switches = _per_backend()
    saved = [s.fp32_precision for s in switches]
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        for s, v in zip(switches, saved):
            s.fp32_precision = v


def in_full_float32(fn):
    """Decorator: ``fn`` runs under ``full_float32``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_float32():
            return fn(*args, **kwargs)

    return wrapper
