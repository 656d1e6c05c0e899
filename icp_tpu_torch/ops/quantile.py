"""Masked approximate quantile by histogram refinement (port of
``icp_tpu/ops/quantile.py``, its single-device form).

Trimmed ICP needs a per-iteration distance threshold tau with
``count(d2 <= tau) >= q * N``.  Two rounds of 32-bin histogram refinement
bracket the quantile to ~1/1024 of the value range; tau is the upper edge
of the first bin whose cumulative count covers the target, so the kept set
is never smaller than asked.  The edges are written in JAX's operation
order, so for the same ``d2`` and mask tau is bit-equal to JAX's in
float32 and in float64.

Where JAX compares every value with every edge (an (N, bins) array that
XLA fuses away), this counts with ``torch.bucketize`` (each value's first
edge at or above it) and a weighted scatter-add into the bins, then a
cumulative sum: the same counts, exact while they stay below 2^24, with no
(N, bins) buffer.  The scatter-add goes to ``_SPREAD`` copies of the bins,
row r into copy r mod ``_SPREAD``, summed after: on the card the distances
crowd into a few bins, and one copy would serialise most of N atomic adds
on one address (66 µs a round at horse on an H100, 2.6 ms of a
20-iteration loop).  Nothing is read to the host: the constants are scalars or
device fills, the bin pick an ``argmax`` and ``index_select``
(``bincount`` would read its maximum, a 0-d index tensor its value).
The tensors that depend only on N (the edge steps, the rows' bin copies,
unit weights) are built once and kept for the next call at that N.

``histogram_quantile_rows`` is the same quantile for each row of a (B, N)
batch (the batched engine's trim), counted by comparing every value with
every edge, as JAX counts: the counts are exact integers either way, so
each row's tau is bit-equal to ``histogram_quantile`` of that row.
"""

from __future__ import annotations

import functools

import torch

_ROUNDS = 2  # refinement rounds
_BINS = 32  # bins a round
_SPREAD = 256  # copies of the bins the scatter-add spreads over


@functools.lru_cache(maxsize=4)
def _constants(n: int, dtype: torch.dtype, device: torch.device) -> tuple:
    """What every quantile over n rows shares, built once for a loop: the
    edge steps 1..bins, each row's offset into its copy of the bins, unit
    row weights and the row count."""
    steps = torch.arange(1, _BINS + 1, dtype=dtype, device=device)
    spread = (torch.arange(n, device=device) % _SPREAD) * (_BINS + 1)
    ones = torch.ones(n, dtype=dtype, device=device)
    return steps, spread, ones, torch.full((), n, dtype=dtype, device=device)


def histogram_quantile(d2: torch.Tensor, q: float, w: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate q-quantile (0-d tensor) of the (N,) values ``d2`` over
    the rows where ``w > 0`` (all rows when ``w`` is None); ``w`` weighs
    each row's count (0/1 masks in the engines)."""
    dt, dev = d2.dtype, d2.device
    steps, spread, ones, n_total = _constants(d2.shape[0], dt, dev)
    wv = None if w is None else w.to(dt)
    masked = d2 if wv is None else torch.where(wv > 0, d2, 0.0)
    hi = masked.max() + 1e-12  # the scalar rounds to dt first, as JAX's asarray
    lo = torch.zeros((), dtype=dt, device=dev)
    if wv is not None:
        n_total, ones = wv.sum(), wv
    target = n_total * q
    for _ in range(_ROUNDS):
        edges = lo + (hi - lo) * steps / _BINS
        # bin b holds the values whose first edge at or above them is b; a
        # value above every edge (or NaN) goes to the spare bin
        slot = torch.where(torch.isnan(d2), _BINS, torch.bucketize(d2, edges))
        cnt = torch.zeros(_SPREAD * (_BINS + 1), dtype=dt, device=dev).index_add_(
            0, slot + spread, ones).view(_SPREAD, _BINS + 1).sum(0)
        cnt = cnt[:_BINS].cumsum(0)  # cnt[j]: weight of the values <= edges[j]
        idx = (cnt >= target).to(torch.uint8).argmax().reshape(1)  # first covering bin
        lo = torch.where(idx > 0, edges.index_select(0, (idx - 1).clamp(min=0)), lo)[0]
        hi = edges.index_select(0, idx)[0]
    return hi


def histogram_quantile_rows(d2: torch.Tensor, q: float,
                            w: torch.Tensor | None = None) -> torch.Tensor:
    """``histogram_quantile`` of each row of (B, N) ``d2`` (with (B, N)
    weights ``w``), as (B,): the edges in the same operation order, the
    counts from a (B, N, bins) comparison."""
    dt, dev = d2.dtype, d2.device
    steps = torch.arange(1, _BINS + 1, dtype=dt, device=dev)
    wv = None if w is None else w.to(dt)
    masked = d2 if wv is None else torch.where(wv > 0, d2, 0.0)
    hi = masked.amax(-1) + 1e-12
    lo = torch.zeros_like(hi)
    n_total = (torch.full_like(hi, d2.shape[-1]) if wv is None else wv.sum(-1))
    target = n_total * q
    for _ in range(_ROUNDS):
        edges = lo[:, None] + (hi - lo)[:, None] * steps / _BINS  # (B, bins)
        le = (d2[:, :, None] <= edges[:, None, :]).to(dt)  # NaN: in no bin
        if wv is not None:
            le = le * wv[:, :, None]
        cnt = le.sum(1)  # (B, bins): weight of the values <= each edge
        idx = (cnt >= target[:, None]).to(torch.uint8).argmax(-1, keepdim=True)
        lo = torch.where(idx[:, 0] > 0,
                         torch.gather(edges, 1, (idx - 1).clamp(min=0))[:, 0], lo)
        hi = torch.gather(edges, 1, idx)[:, 0]
    return hi
