"""Sharded ICP on ``torch.distributed`` (port of
``icp_tpu/parallel/sharded.py``): scene and model rows split over the
ranks of a ``DeviceMesh`` (``parallel/mesh.py``).

JAX runs one program over global arrays under ``shard_map``; here every
rank calls the entry point with the same full inputs, pads them as JAX
pads (scene rows with 0 and a 0 mask, model rows at 1e17, so a pad row
never wins a fold), keeps its equal slice of the rows and runs the loop on
it.  The collectives are JAX's, one to one: ``psum`` is ``all_reduce``,
``all_gather`` is ``all_gather``, ``ppermute`` is a ``batch_isend_irecv``
ring (send to rank + 1, receive from rank - 1 in one batch, so the ring
cannot deadlock).  Every rank returns the whole un-padded result, the
points gathered from all ranks.

  * Correspondence: the ring fold.  On each of the ``n`` hops a rank finds
    its scene rows' nearest points in the model shard it holds (K1 with
    distances for ``nn_method="pallas"``, else JAX's expansion form
    ``|m|^2 - 2 p.m`` in full float32), folds them into its best so far by
    (distance, lowest GLOBAL index) and passes the shard on; the matched
    points (and per-model-point payloads: normals, covariances) are
    gathered during the fold.  The shard is not passed after the last
    hop, so a world-1 ring sends nothing.  Both distance forms are the
    same formula on every hop, so the cross-hop ties compare exactly.
    ``ring=False`` gathers the whole model once instead.
  * Statistics: the weighted Horn sums of a rank's rows, packed into one
    float64 vector and all-reduced once; the solve (K5 for
    ``solver="qcp_fused"``) then runs replicated on every rank, as JAX's
    runs on the replicated statistics.  The residual sum is a second
    all-reduce; trimmed runs add the distributed quantile's
    (``ops/quantile.histogram_quantile(group=...)``).
  * The loop stays on the device, as the single-device engines' loops
    (``engine/icp.LoopState``): the error is all-reduced, so every rank
    computes the same done flag, makes the same collective calls and reads
    the flag once per chunk of iterations; a converged state is frozen with
    ``torch.where``, never by leaving the loop early on one rank.

``icp_sharded_2d`` splits the scene over the ``sp`` axis and the model over
``mp`` of a 2-D mesh; ``gn_sharded`` is the plane engines' (point-to-plane,
symmetric, GICP) ring loop with the model side rows riding the ring.
Every entry point runs under ``utils.precision.full_float32``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from icp_tpu_torch.config import ICPConfig
from icp_tpu_torch.engine.icp import ICPTrace, LoopState, as_points
from icp_tpu_torch.engine.plane import _advance
from icp_tpu_torch.ops.alignment import (
    AlignmentStats,
    Similarity,
    alignment_from_stats,
    compute_alignment_stats,
)
from icp_tpu_torch.ops.quantile import histogram_quantile
from icp_tpu_torch.ops.transform import apply_similarity, identity_similarity
from icp_tpu_torch.parallel.mesh import (
    ensure_process_group,
    make_mesh,
    mesh_device,
    shard_rows,
)
from icp_tpu_torch.utils.precision import in_full_float32

_INT_MAX = 2 ** 31 - 1
_BIG = 3.0e38
_MODEL_PAD = 1.0e17  # model pad rows: never a nearest neighbour
_BLOCK_ELEMS = 1 << 24  # distance elements per block of the expansion form


class Axis:
    """One mesh axis as a loop sees it: its process group, its size and
    this rank's index on it."""

    def __init__(self, mesh: DeviceMesh, name: str):
        self.group = mesh.get_group(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        self.rank = mesh.get_local_rank(name)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


_ALIGN = 16  # bytes: each packed tensor starts aligned for the kernels' vector loads


def _nbytes(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN


def _pack(tensors) -> torch.Tensor:
    """The tensors' bytes in one flat uint8 buffer, each at a multiple of
    ``_ALIGN``."""
    buf = torch.zeros(sum(_nbytes(t) for t in tensors), dtype=torch.uint8,
                      device=tensors[0].device)
    at = 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        buf[at:at + nb] = t.contiguous().reshape(-1).view(torch.uint8)
        at += _nbytes(t)
    return buf


def _unpack(buf: torch.Tensor, like) -> list:
    """Tensors shaped and typed as ``like`` from ``_pack``'s buffer (views
    of it)."""
    out, at = [], 0
    for t in like:
        nb = t.numel() * t.element_size()
        out.append(buf[at:at + nb].view(t.dtype).reshape(t.shape))
        at += _nbytes(t)
    return out


def psum(tensors, group) -> list:
    """Each tensor summed over the ranks of ``group``: one all-reduce of
    their float64 values packed together; returned in their own dtypes."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def ppermute(tensors, axis: Axis) -> list:
    """The tensors of rank - 1 along ``axis`` (this rank's go to rank + 1),
    in one buffer and one batch of a send and a receive."""
    buf = _pack(tensors)
    got = torch.empty_like(buf)
    nxt = dist.get_global_rank(axis.group, (axis.rank + 1) % axis.size)
    prv = dist.get_global_rank(axis.group, (axis.rank - 1) % axis.size)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, nxt, axis.group),
                                       dist.P2POp(dist.irecv, got, prv, axis.group)]):
        req.wait()
    return _unpack(got, tensors)


def all_gather(tensors, axis: Axis) -> list:
    """Each tensor stacked over the ranks of ``axis``: (size, ...) in rank
    order, JAX's untiled ``all_gather``, one collective for all of them."""
    buf = _pack(tensors)
    outs = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(outs, buf, group=axis.group)
    parts = [_unpack(o, tensors) for o in outs]
    return [torch.stack([p[i] for p in parts]) for i in range(len(tensors))]


def gather_rows(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The rows of every rank along ``axis``, concatenated in rank order
    (JAX's ``all_gather(tiled=True)``)."""
    return all_gather([t], axis)[0].reshape((-1,) + t.shape[1:])


# ---------------------------------------------------------------------------
# correspondence
# ---------------------------------------------------------------------------


def _local_partial_argmin(p_loc: torch.Tensor, m_cur: torch.Tensor, nn_impl: str):
    """(distance, local argmin) of each scene row against one model shard.

    ``"pallas"``: K1 with its diff-squares float32 distances.  Otherwise
    JAX's expansion form ``|m|^2 - 2 p.m`` in the clouds' dtype (``|p|^2``
    is the same on every hop, so dropping it keeps the argmin and the
    cross-hop ties), in scene blocks so no N x M matrix exists beyond one.
    Both are one formula on every hop: the fold's ties compare exactly."""
    if nn_impl == "pallas":
        from icp_tpu_torch.kernels.nn_dense import nn_dense

        idx, d2 = nn_dense(p_loc.to(torch.float32).contiguous(),
                           m_cur.to(torch.float32).contiguous(), with_dist=True)
        return d2, idx
    mn = (m_cur * m_cur).sum(1)
    rows = max(1, _BLOCK_ELEMS // max(m_cur.shape[0], 1))
    ds, idxs = [], []
    for lo in range(0, p_loc.shape[0], rows):
        d = mn[None, :] - 2.0 * (p_loc[lo:lo + rows] @ m_cur.T)
        idx = torch.argmin(d, dim=1)  # first index of the minimum, as jnp.argmin
        ds.append(torch.gather(d, 1, idx[:, None])[:, 0])
        idxs.append(idx.to(torch.int32))
    return torch.cat(ds), torch.cat(idxs)


def _fold(best, d, gi, rows):
    """Fold one hop's (distance, global index, gathered rows) into the best
    so far: the lesser distance, ties to the lower global index."""
    best_d, best_i, best_rows = best
    better = (d < best_d) | ((d == best_d) & (gi < best_i))
    return (torch.where(better, d, best_d), torch.where(better, gi, best_i),
            [torch.where(better.reshape((-1,) + (1,) * (r.dim() - 1)), r, b)
             for r, b in zip(rows, best_rows)])


def _fold_start(d, n: int, rows):
    """The fold's start: distance _BIG, index _INT_MAX, zero rows."""
    return (torch.full((n,), _BIG, dtype=d.dtype, device=d.device),
            torch.full((n,), _INT_MAX, dtype=torch.int32, device=d.device),
            [torch.zeros_like(r) for r in rows])


def _ring_correspond(p_loc, m_loc, axis: Axis, nn_impl: str, payload=()):
    """Ring NN fold: (matched model points, global indices, [payload rows]).

    ``payload``: per-model-point tensors (M_loc, ...) that ride the ring
    with the model shard; each winning row is gathered during the fold."""
    m_shard = m_loc.shape[0]
    held = [m_loc, *payload]
    best = None
    for k in range(axis.size):
        src = (axis.rank - k) % axis.size  # owner of the held shard
        d, idx = _local_partial_argmin(p_loc, held[0], nn_impl)
        rows = [x[idx.long()] for x in held]
        if best is None:
            best = _fold_start(d, p_loc.shape[0], rows)
        best = _fold(best, d, idx + src * m_shard, rows)
        if k < axis.size - 1:  # no pass after the last hop
            held = ppermute(held, axis)
    _, best_i, best_rows = best
    return best_rows[0], best_i, best_rows[1:]


def _allgather_correspond(p_loc, m_loc, axis: Axis, nn_impl: str, payload=()):
    """Small-model variant: gather the whole model once, local NN."""
    full = [gather_rows(x, axis) for x in (m_loc, *payload)]
    _, idx = _local_partial_argmin(p_loc, full[0], nn_impl)
    return full[0][idx.long()], idx, [x[idx.long()] for x in full[1:]]


def _correspond_2d(p_loc, m_loc, axis: Axis, nn_impl: str):
    """Block-local argmin against the held model shard, then the (distance,
    global index, point) candidates gathered over the model axis and folded
    in rank order, ties to the lower global index."""
    d, idx = _local_partial_argmin(p_loc, m_loc, nn_impl)
    gi = idx + axis.rank * m_loc.shape[0]
    d_all, gi_all, pt_all = all_gather([d, gi, m_loc[idx.long()]], axis)
    best = _fold_start(d, p_loc.shape[0], [pt_all[0]])
    for k in range(axis.size):
        best = _fold(best, d_all[k], gi_all[k], [pt_all[k]])
    return best[2][0], best[1]


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------


def sq_rows(d: torch.Tensor) -> torch.Tensor:
    """Row sums of squares, as JAX's ``jnp.sum(d ** 2, axis=1)``."""
    return (d * d).sum(1)


def trimmed(w, d2, trim_fraction: float, group):
    """``w`` times the trim's 0/1 weights: the rows within the distributed
    ``1 - trim_fraction`` quantile of ``d2`` over every rank's rows of
    weight > 0."""
    if trim_fraction <= 0.0:
        return w
    tau = histogram_quantile(d2, 1.0 - trim_fraction, w, group=group)
    return w * (d2 <= tau).to(w.dtype)


def masked_stats(p, y, w, group) -> AlignmentStats:
    """The global Horn sums of the weighted rows of every rank: float64
    local sums, one all-reduce."""
    return AlignmentStats(*psum(compute_alignment_stats(p, y, acc_dtype=torch.float64,
                                                        weights=w), group))


def similarity_step(p, y, w, group, *, solver: str, with_scale: bool,
                    reference_compat: bool):
    """One replicated alignment step of the weighted rows of every rank:
    (Similarity in p's dtype, p_new, float64 error)."""
    stats = masked_stats(p, y, w, group)
    sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
    sim = Similarity(*(v.to(p.dtype) for v in sim))
    p_new = apply_similarity(p, sim)
    (err_sum,) = psum([torch.sum(w * sq_rows(y - p_new), dtype=torch.float64)], group)
    err = err_sum / stats.n
    return sim, p_new, 2.0 * err if reference_compat else err


def run_loop(step, state: dict, loop: LoopState, dt, trace: bool, engine=None):
    """Run ``step(state)`` (which returns (sim, p_new, err, extra updates))
    until the done flag; the updates are gated by the flag, so every rank
    runs the same iterations and collectives.  ``engine``: the plane
    engine whose scene side data (``state["side"]``) co-rotates."""

    def one():
        sim, p_new, err, more = step(state)
        _advance(engine, loop, state, sim, p_new, err, **more)

    loop.run(one)
    return loop.finish(state["p"], state["total"], dt, trace)


def check_trace_bound(trace: bool, n_iters, max_iter: int) -> None:
    """The error trace holds ``max_iter`` entries: refuse a larger bound."""
    if trace and n_iters is not None and int(n_iters) > max_iter:
        raise ValueError(f"trace=True records at most config.max_iter={max_iter} "
                         f"iterations but n_iters={int(n_iters)}; raise max_iter or drop trace")


def gathered(out, axis: Axis, n: int, trace: bool, order=None):
    """The result with every rank's points (in its row ``order``, when
    given) gathered along ``axis`` and the pad rows cut."""
    res = out.result if trace else out
    points = res.points if order is None else res.points[order]
    res = res._replace(points=gather_rows(points, axis)[:n])
    return ICPTrace(result=res, errs=out.errs) if trace else res


def prepared(model, scene, cfg: ICPConfig, mesh: Optional[DeviceMesh]):
    """(mesh, this rank's device, model, scene) with the clouds as tensors
    of ``cfg.dtype`` on it.  With no mesh, ``make_mesh`` on the clouds'
    device type (the card for arrays).  Tensors on another type of device
    than the mesh's raise: nothing moves between the card and the CPU
    unasked."""
    if mesh is None:
        kinds = [x.device.type for x in (model, scene) if isinstance(x, torch.Tensor)]
        mesh = make_mesh(kinds[0] if kinds else None)
    dev = mesh_device(mesh)
    for x in (model, scene):
        if isinstance(x, torch.Tensor) and x.device.type != dev.type:
            raise ValueError(f"a cloud is on {x.device.type!r} but the mesh is on {dev.type!r}")
    model = as_points(model, cfg.dtype, dev)
    return mesh, dev, model, as_points(scene, cfg.dtype, dev)


def dense_nn_impl(cfg: ICPConfig, backend: str) -> str:
    """K1 when the NN method resolves to ``"pallas"``, else the expansion
    form (JAX's ``"jnp"``)."""
    return "pallas" if cfg.resolved_nn_method(backend) == "pallas" else "jnp"


@in_full_float32
def icp_sharded(model, scene, config: Optional[ICPConfig] = None, *,
                mesh: Optional[DeviceMesh] = None, ring: bool = True, trace: bool = False,
                n_iters=None):
    """ICP over a 1-D ``points`` mesh: ``icp``'s contract (an
    ``ICPResult``, an ``ICPTrace`` with ``trace=True``, the points
    un-padded) on every rank.  Every rank passes the same full clouds.
    ``n_iters``: an early-exit bound in place of ``config.max_iter``.
    ``nn_method`` resolving to ``"grid"`` runs ``icp_sharded_grid``;
    ``ring=False`` gathers the model once instead of the ring.  The mesh
    defaults to ``make_mesh()`` on the clouds' device (a world-1 group
    when none exists)."""
    cfg = config or ICPConfig()
    check_trace_bound(trace, n_iters, cfg.max_iter)
    mesh, dev, model, scene = prepared(model, scene, cfg, mesh)
    backend = dev.type
    if cfg.resolved_nn_method(backend, max(model.shape[0], scene.shape[0])) == "grid":
        from icp_tpu_torch.parallel.sharded_grid import icp_sharded_grid

        return icp_sharded_grid(model, scene, cfg, mesh=mesh, trace=trace, n_iters=n_iters)
    axis = Axis(mesh, mesh.mesh_dim_names[0])
    dt, n = cfg.dtype, scene.shape[0]
    p = shard_rows(scene, mesh)
    m_loc = shard_rows(model, mesh, _MODEL_PAD)
    w = shard_rows(torch.ones(n, dtype=dt, device=dev), mesh)
    nn_impl = dense_nn_impl(cfg, backend)
    correspond = _ring_correspond if ring else _allgather_correspond
    kw = dict(solver=cfg.resolved_solver(backend), with_scale=cfg.with_scale,
              reference_compat=cfg.reference_compat)

    def step(state):
        p = state["p"]
        y, _, _ = correspond(p, m_loc, axis, nn_impl)
        w_eff = trimmed(w, sq_rows(y - p), cfg.trim_fraction, axis.group)
        return (*similarity_step(p, y, w_eff, axis.group, **kw), {})

    bound = cfg.max_iter if n_iters is None else int(n_iters)
    # n_iters may exceed max_iter without a trace, as in JAX: the buffer
    # then holds every iteration's error
    loop = LoopState(bound, max(bound, cfg.max_iter), cfg.threshold, cfg.reference_compat, dev)
    state = dict(p=p, side=None, total=identity_similarity(dt, dev))
    return gathered(run_loop(step, state, loop, dt, trace), axis, n, trace)


# ---------------------------------------------------------------------------
# 2-D mesh: scene over 'sp', model over 'mp'
# ---------------------------------------------------------------------------


def make_mesh_2d(n_sp: int, n_mp: int, devices=None) -> DeviceMesh:
    """(sp, mp) mesh over the ranks of the process group (which must number
    ``n_sp * n_mp``): scene rows split over ``sp``, model rows over ``mp``,
    each rank one (N/sp, M/mp) block of the distance problem."""
    kind = ensure_process_group(devices)
    if dist.get_world_size() != n_sp * n_mp:
        raise ValueError(f"make_mesh_2d({n_sp}, {n_mp}) needs {n_sp * n_mp} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(kind, (n_sp, n_mp), mesh_dim_names=("sp", "mp"))


@in_full_float32
def icp_sharded_2d(model, scene, config: Optional[ICPConfig] = None, *,
                   mesh: DeviceMesh, trace: bool = False):
    """ICP over a 2-D (sp, mp) mesh: the scene rows split over ``sp``
    (replicated over ``mp``), the model rows over ``mp``; the candidates
    gathered and folded over ``mp``, the sums reduced over ``sp``.
    ``trace=True`` returns an ``ICPTrace``."""
    cfg = config or ICPConfig()
    mesh, dev, model, scene = prepared(model, scene, cfg, mesh)
    sp, mp = Axis(mesh, "sp"), Axis(mesh, "mp")
    dt, n = cfg.dtype, scene.shape[0]
    p = shard_rows(scene, mesh, axis="sp")
    m_loc = shard_rows(model, mesh, _MODEL_PAD, axis="mp")
    w = shard_rows(torch.ones(n, dtype=dt, device=dev), mesh, axis="sp")
    nn_impl = dense_nn_impl(cfg, dev.type)
    kw = dict(solver=cfg.resolved_solver(dev.type), with_scale=cfg.with_scale,
              reference_compat=cfg.reference_compat)

    def step(state):
        p = state["p"]
        y, _ = _correspond_2d(p, m_loc, mp, nn_impl)
        # the scene rows (and y, folded alike on every mp rank) are
        # replicated over mp: the quantile and the sums reduce over sp
        w_eff = trimmed(w, sq_rows(y - p), cfg.trim_fraction, sp.group)
        return (*similarity_step(p, y, w_eff, sp.group, **kw), {})

    loop = LoopState(cfg.max_iter, cfg.max_iter, cfg.threshold, cfg.reference_compat, dev)
    state = dict(p=p, side=None, total=identity_similarity(dt, dev))
    return gathered(run_loop(step, state, loop, dt, trace), sp, n, trace)


# ---------------------------------------------------------------------------
# the plane engines' ring loop
# ---------------------------------------------------------------------------


def plane_engine(name: str, eps: float):
    """(``PlaneEngine``, scene side data of the scene normals or None) of an
    engine of the ``--engine`` names."""
    if name == "point_to_plane":
        from icp_tpu_torch.engine.point_to_plane import POINT_TO_PLANE

        return POINT_TO_PLANE, None
    if name == "symmetric":
        from icp_tpu_torch.engine.symmetric import SYMMETRIC

        return SYMMETRIC, lambda normals: normals
    if name == "gicp":
        from icp_tpu_torch.engine.gicp import disk_covariances, gicp_engine

        return gicp_engine(eps), lambda normals: disk_covariances(normals, eps)
    raise ValueError(f"unknown plane engine {name!r}")


def reducer(group):
    """The ``reduce`` hook of the plane steps: their sums over every rank."""
    return lambda *tensors: psum(tensors, group)


@in_full_float32
def gn_sharded(engine_name: str, model, scene, config: Optional[ICPConfig] = None, *,
               model_normals=None, scene_normals=None, normal_k: int = 16,
               eps: float = 1e-3, mesh: Optional[DeviceMesh] = None, trace: bool = False,
               validate: bool = False):
    """The sharded plane engines (``icp_point_to_plane_sharded``,
    ``icp_symmetric_sharded``, ``icp_generalized_sharded``): normals
    estimated on the whole clouds before sharding (K6 or K7 on the card),
    then the ring fold with the model side rows (normals, or GICP's
    covariances) riding the ring as payload and the scene's side rows
    (normals or covariances) sharded with its points; the 6x6 normal
    equations all-reduced, the solve replicated.  An NN method resolving
    to ``"grid"`` runs ``sharded_grid.gn_sharded_grid``; ``validate``: the
    dense path checks the inputs as the single-device engines do (JAX's
    symmetric engine alone)."""
    from icp_tpu_torch.engine.icp import _validate
    from icp_tpu_torch.ops.normals import estimate_normals

    cfg = config or ICPConfig()
    mesh, dev, model, scene = prepared(model, scene, cfg, mesh)
    engine, side_of = plane_engine(engine_name, eps)
    if model_normals is None:
        model_normals = estimate_normals(model, k=normal_k)
    model_normals = as_points(model_normals, cfg.dtype, dev)
    if side_of is not None:
        scene_normals = (estimate_normals(scene, k=normal_k) if scene_normals is None
                         else as_points(scene_normals, cfg.dtype, dev))
    if cfg.resolved_nn_method(dev.type, max(model.shape[0], scene.shape[0])) == "grid":
        from icp_tpu_torch.parallel.sharded_grid import gn_sharded_grid

        return gn_sharded_grid(engine, side_of, model, model_normals, scene, scene_normals,
                               cfg, mesh=mesh, trace=trace)
    if validate:
        _validate(model, scene, cfg)
    axis = Axis(mesh, mesh.mesh_dim_names[0])
    dt, n = cfg.dtype, scene.shape[0]
    p = shard_rows(scene, mesh)
    m_loc = shard_rows(model, mesh, _MODEL_PAD)
    # pad rows get zero normals: GICP's covariance of those is the identity
    m_side = engine.rows(shard_rows(model_normals, mesh))
    s_side = None if side_of is None else side_of(shard_rows(scene_normals, mesh))
    w = shard_rows(torch.ones(n, dtype=dt, device=dev), mesh)
    nn_impl = dense_nn_impl(cfg, dev.type)
    reduce = reducer(axis.group)

    def step(state):
        p = state["p"]
        y, _, (y_side,) = _ring_correspond(p, m_loc, axis, nn_impl, payload=(m_side,))
        w_eff = trimmed(w, sq_rows(y - p), cfg.trim_fraction, axis.group)
        return (*engine.step(p, y, y_side, state["side"], w_eff, reduce=reduce), {})

    loop = LoopState(cfg.max_iter, cfg.max_iter, cfg.threshold, False, dev)
    state = dict(p=p, side=s_side, total=identity_similarity(dt, dev))
    return gathered(run_loop(step, state, loop, dt, trace, engine), axis, n, trace)
