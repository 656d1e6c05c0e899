"""K1-K10 on the card against their plain versions, K2's fixed mode, K2's
and K3's guard status word, the trimmed loop's launches, and the symmetric
and GICP grid loops against their dense loops (``cuda`` marker).

These need a CUDA device and ``nvcc``; without a card they skip.  On a
machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import os

import numpy as np
import pytest
import torch

from icp_tpu_torch.kernels import (
    _build,
    icp_fused,
    knn_dense,
    knn_grid,
    nn_bf16,
    nn_dense,
    nn_grid,
    qcp,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _cloud(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.tensor(scale * rng.standard_normal((n, 3)), dtype=torch.float32)


@pytest.mark.parametrize("n,m", [(1, 1), (300, 2049), (5000, 700)])
def test_nn_dense_kernel_matches_plain(dev, n, m):
    s, mo = _cloud(n, n).to(dev), _cloud(m, m, 2.0).to(dev)
    mo[m // 2:] = mo[: m - m // 2].clone()  # duplicates: lowest index wins
    before = _build.LAUNCHES["nn_dense"]
    ik, dk = nn_dense.nn_dense(s, mo, with_dist=True)
    ip, dp = nn_dense.nn_dense_plain(s, mo, with_dist=True)
    assert _build.LAUNCHES["nn_dense"] == before + 1
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


@pytest.mark.parametrize("n,m", [(1, 1), (1, 5000), (700, 3001), (4099, 1000)])
def test_nn_dense_kernel_across_model_chunks(dev, n, m):
    """K1's model chunks merge by the lowest index of the least distance:
    each of the first rows is repeated one chunk later (other blocks fold
    it), m is not a multiple of the chunk, and a scene row whose distances
    all overflow keeps index 0 and d2 = +inf."""
    s, mo = _cloud(n + 7, n).to(dev), _cloud(m + 8, m, 2.0).to(dev)
    chunk = nn_dense.chunk_rows(n, m)
    r = max(0, min(chunk, m - chunk))  # rows repeated in the next chunk
    assert chunk % 128 == 0 and (r == 0 or m % chunk)
    mo[chunk:chunk + r] = mo[:r].clone()
    s[0] = torch.tensor([3e38, -3e38, 3e38], device=dev)
    before = _build.LAUNCHES["nn_dense"]
    ik, dk = nn_dense.nn_dense(s, mo, with_dist=True)
    assert _build.LAUNCHES["nn_dense"] == before + 1
    ip, dp = nn_dense.nn_dense_plain(s, mo, with_dist=True)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert int(ik[0]) == 0 and torch.isinf(dk[0])
    assert not bool(((ik >= chunk) & (ik < chunk + r)).any())  # the lower copy wins


@pytest.mark.parametrize("case", ["n1_m1", "ragged", "duplicates", "far", "no_finite"])
def test_nn_dense_mxu_kernel_matches_plain(dev, case):
    """K10 (``distance_impl="mxu"``) bit-equal to its plain version:
    ``ragged``: m not a multiple of the chunk; ``duplicates``: the first
    rows repeated one chunk later (the lowest index wins across the merge);
    ``far``: clouds 40 units from the origin, so every expansion distance
    is negative (the key's order-preserving map); ``no_finite``: a NaN
    scene row gets index 0 and +inf."""
    n, m = {"n1_m1": (1, 1), "ragged": (700, 3001), "duplicates": (4099, 1000),
            "far": (2000, 2500), "no_finite": (300, 2049)}[case]
    s, mo = _cloud(n + 21, n).to(dev), _cloud(m + 22, m, 2.0).to(dev)
    chunk = nn_dense.chunk_rows(n, m, "mxu")
    if case == "duplicates":
        r = max(0, min(chunk, m - chunk))
        mo[chunk:chunk + r] = mo[:r].clone()
    if case == "far":
        s, mo = s + 40.0, mo + 40.0
    if case == "no_finite":
        s[7] = float("nan")
    before = _build.LAUNCHES["nn_dense_mxu"]
    ik, dk = nn_dense.nn_dense(s, mo, with_dist=True, distance_impl="mxu")
    assert _build.LAUNCHES["nn_dense_mxu"] == before + 1
    ip, dp = nn_dense.nn_dense_plain(s, mo, with_dist=True, distance_impl="mxu")
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert torch.equal(nn_dense.closest_point_indices_dense(s, mo, distance_impl="mxu"), ik)
    if case == "duplicates":
        assert chunk < m and not bool(((ik >= chunk) & (ik < chunk + r)).any())
    if case == "no_finite":
        assert int(ik[7]) == 0 and float(dk[7]) == float("inf")


def test_qcp_step_kernel_fixed_mode_runs_to_the_bound(dev):
    """K2 with NaN partials: in fixed mode (``converge=False``) only the
    bound stops it; in convergence mode the NaN error stops it at once.  The
    warp form's state is the plain version's, NaN for NaN."""
    parts = torch.full((3, qcp.N_SUMS), float("nan"), dtype=torch.float64, device=dev)
    for converge, want in ((False, 5), (True, 1)):
        outs = []
        for fn in (qcp.qcp_step, qcp.qcp_step_plain):
            st, ctl, errs = qcp.identity_state(dev), qcp.new_loop_control(5, dev), qcp.new_err_buffer(5, dev)
            for _ in range(7):
                fn(parts, st, ctl, errs, threshold=1e-5, converge=converge)
            assert ctl.tolist() == [want, 1, 5, 0]
            assert bool(torch.isnan(errs[:want]).all())
            outs.append(st)
        assert torch.equal(torch.isnan(outs[0]), torch.isnan(outs[1]))
        fin = ~torch.isnan(outs[1])
        assert torch.equal(outs[0][fin], outs[1][fin])


@pytest.mark.parametrize("rows", [1, 7, 23])
def test_qcp_step_kernel_matches_plain(dev, rows):
    """K2 on one warp: bit-equal to its plain version (the same operation
    order under --fmad=false), from a non-identity state."""
    p, y = _cloud(1, 500).double(), _cloud(2, 500).double()
    from icp_tpu_torch.ops.alignment import Similarity, compute_alignment_stats

    parts = torch.cat([qcp.pack_stats(compute_alignment_stats(a.to(dev), b.to(dev)))
                       for a, b in zip(p.chunk(rows), y.chunk(rows))])
    assert parts.shape[0] == rows
    prev = qcp.pack_total_state(Similarity(torch.tensor(0.9), torch.eye(3, dtype=torch.float64),
                                           torch.tensor([0.1, -0.2, 0.3])), dev)
    outs = []
    for fn in (qcp.qcp_step, qcp.qcp_step_plain):
        st, ctl, errs = prev.clone(), qcp.new_loop_control(3, dev), qcp.new_err_buffer(3, dev)
        fn(parts, st, ctl, errs, threshold=1e-5)
        outs.append((st, ctl, errs))
    assert torch.equal(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-12)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][2][:1], outs[1][2][:1])


def _warm_state(dev):
    from icp_tpu_torch.ops.alignment import Similarity

    a = 0.3
    R = torch.tensor([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float64)
    return qcp.pack_total_state(Similarity(torch.tensor(1.04), R,
                                           torch.tensor([0.05, -0.1, 0.02])), dev)


def _fused_case(dev, case):
    """(scene, model) on the card for the K3 cases."""
    if case == "cow":
        from icp_tpu_torch.io.csv import load_matrix

        data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
        return tuple(torch.tensor(load_matrix(os.path.join(data, f)), dtype=torch.float32).to(dev)
                     for f in ("cow_tr1.txt", "cow_ref.txt"))
    n, m = {"1000x1500": (1000, 1500), "20000x5120": (20000, 5120)}[case]
    return _cloud(3, n).to(dev), (_cloud(4, m) * 1.1).to(dev)


def _fused_vs_plain(prep, state0, bound=4):
    """One K3 launch and its plain composition from ``state0``:
    ((state, ctl, errs) of each, and the kernel's rows)."""
    dev = state0.device
    outs = []
    for kernel in (True, False):
        st, ctl, errs = state0.clone(), qcp.new_loop_control(bound, dev), qcp.new_err_buffer(bound, dev)
        if kernel:
            before = _build.LAUNCHES["icp_fused"]
            icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=1e-5, err_factor=2.0)
            assert _build.LAUNCHES["icp_fused"] == before + 1
            rows = prep.rows.clone()
        else:
            qcp.qcp_step_plain(icp_fused.fused_partials_plain(prep, st), st, ctl, errs,
                               threshold=1e-5, err_factor=2.0)
        outs.append((st, ctl, errs))
    return outs, rows


def _workspace_clean(prep):
    return bool((prep.keys == -1).all()) and bool((prep.counts == 0).all())


@pytest.mark.parametrize("warm", [False, True], ids=["identity", "warm"])
@pytest.mark.parametrize("case", ["1000x1500", "cow", "20000x5120"])
def test_icp_fused_kernel_matches_plain(dev, case, warm):
    """One K3 launch against ``fused_partials_plain`` + ``qcp_step_plain``:
    the rows' sums within relative 1e-9 (another summation order), the
    state within 1e-8, ctl equal, errs[0] within relative 1e-9; the state
    bit-equal to K2's plain step on the kernel's own rows; a run repeats
    bit for bit; the workspace is clean after each launch."""
    scene, model = _fused_case(dev, case)
    prep = icp_fused.prepare_fused_inputs(scene, model)
    state0 = _warm_state(dev) if warm else qcp.identity_state(dev)
    blocks = -(-scene.shape[0] // 512)
    assert prep.rows.shape == (blocks, qcp.N_SUMS) and _workspace_clean(prep)
    ((kst, kctl, kerrs), (pst, pctl, perrs)), rows = _fused_vs_plain(prep, state0)
    assert _workspace_clean(prep)
    want = icp_fused.fused_partials_plain(prep, state0)[0]
    rel = ((rows.sum(0) - want).abs() / want.abs().clamp(min=1.0)).max()
    assert float(rel) <= 1e-9
    assert float(rows[:, 17].sum()) == scene.shape[0]
    torch.testing.assert_close(kst, pst, rtol=0, atol=1e-8)
    assert torch.equal(kctl, pctl)
    torch.testing.assert_close(kerrs[:1], perrs[:1], rtol=1e-9, atol=0)
    own, octl, oerrs = state0.clone(), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
    qcp.qcp_step_plain(rows, own, octl, oerrs, threshold=1e-5, err_factor=2.0)
    assert torch.equal(own, kst) and torch.equal(octl, kctl)
    assert torch.equal(oerrs[:1], kerrs[:1])  # the rest is the buffer's untouched NaN
    for _ in range(2):  # the same launch again: bit for bit
        st, ctl, errs = state0.clone(), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
        icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=1e-5, err_factor=2.0)
        assert torch.equal(st, kst) and torch.equal(errs[:1], kerrs[:1])
        assert torch.equal(prep.rows, rows) and _workspace_clean(prep)


def test_icp_fused_kernel_ties_across_chunks_go_to_lowest_index(dev):
    """Scene points on the plane x = 0 and model rows mirrored across it,
    each mirror one chunk later than its row: every expansion distance
    ties exactly (px * m2x is 0), so the lowest index must win the merge,
    whatever order the chunk blocks finish in; the y sums then hold the
    rows' positive x, and equal the plain version's."""
    rng = np.random.default_rng(12)
    n, m, r = 2000, 3000, 100
    chunk = icp_fused.chunk_rows(n, m)
    assert chunk + r <= m
    model = np.empty((m, 3), np.float32)
    model[:, 0] = rng.uniform(20.0, 30.0, m)  # far rows
    model[:, 1:] = rng.standard_normal((m, 2))
    model[:r, 0] = rng.uniform(0.5, 1.0, r)
    model[chunk:chunk + r] = model[:r] * np.float32([-1.0, 1.0, 1.0])
    scene = np.zeros((n, 3), np.float32)
    scene[:, 1:] = model[rng.integers(0, r, n), 1:] + 0.01 * rng.standard_normal((n, 2))
    prep = icp_fused.prepare_fused_inputs(torch.tensor(scene, device=dev),
                                          torch.tensor(model, device=dev))
    ((kst, _, _), (pst, _, _)), rows = _fused_vs_plain(prep, qcp.identity_state(dev))
    rows = rows.sum(0)
    want = icp_fused.fused_partials_plain(prep, qcp.identity_state(dev))[0]
    assert float(((rows - want).abs() / want.abs().clamp(min=1.0)).max()) <= 1e-9
    assert float(rows[12]) > 0.5 * n  # sum of y_x: the rows, not their mirrors
    torch.testing.assert_close(kst, pst, rtol=0, atol=1e-8)


@pytest.mark.parametrize("where", ["scene", "model"])
def test_icp_fused_kernel_with_a_nan_row(dev, where):
    """A NaN scene row (no finite distance: y = 0) and a NaN model row
    (never wins) against the plain versions: equal control, the same NaN
    pattern in the state, equal finite slots (1e-8) and the rows' finite
    y sums within relative 1e-9."""
    scene, model = _cloud(13, 1000).to(dev), (_cloud(14, 1500) * 1.1).to(dev)
    if where == "scene":
        scene[17, 1] = float("nan")
    else:
        model[400, 2] = float("nan")
    prep = icp_fused.prepare_fused_inputs(scene, model)
    ((kst, kctl, kerrs), (pst, pctl, perrs)), rows = _fused_vs_plain(prep, qcp.identity_state(dev))
    assert torch.equal(kctl, pctl) and _workspace_clean(prep)
    assert torch.equal(torch.isnan(kst), torch.isnan(pst))
    fin = ~torch.isnan(pst)
    torch.testing.assert_close(kst[fin], pst[fin], rtol=0, atol=1e-8)
    want = icp_fused.fused_partials_plain(prep, qcp.identity_state(dev))[0]
    y_cols = [12, 13, 14, 16]
    got = rows.sum(0)[y_cols]
    assert float(((got - want[y_cols]).abs() / want[y_cols].abs().clamp(min=1.0)).max()) <= 1e-9
    if where == "model":
        assert bool(torch.isfinite(kst).all()) and bool(torch.isfinite(kerrs[:1]).all())


def test_icp_fused_kernel_when_done_writes_the_identity_step(dev):
    """With the done flag up, the launch writes the identity step (slots
    0-12) and changes nothing else: a later apply of the step is an exact
    no-op; the workspace stays clean."""
    prep = icp_fused.prepare_fused_inputs(_cloud(15, 3000).to(dev), _cloud(16, 2000).to(dev))
    st = _warm_state(dev)
    st[0, :13] = torch.arange(13, dtype=torch.float64, device=dev)
    ctl = torch.tensor([3, 1, 8, 0], dtype=torch.int32, device=dev)
    errs = qcp.new_err_buffer(8, dev)
    before = st.clone()
    icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=1e-5)
    torch.cuda.synchronize()
    want = torch.zeros(13, dtype=torch.float64, device=dev)
    want[[0, 1, 5, 9]] = 1.0
    assert torch.equal(st[0, :13], want) and torch.equal(st[0, 13:], before[0, 13:])
    assert ctl.tolist() == [3, 1, 8, 0] and bool(torch.isnan(errs).all())
    assert _workspace_clean(prep)


@pytest.mark.parametrize("cap,case", [(16, "random"), (1, "random"), (16, "straggler"),
                                      (1, "duplicates"), (16, "ragged")])
def test_nn_grid_kernel_matches_plain_and_brute_force(dev, cap, case):
    """``straggler``: one scene tile past the capacity among tiles with one
    candidate (its fold is cut into many work items); ``duplicates``: 1,024
    model points and their mirror images across x = 0, which the first kd
    split (x, the widest axis) puts in other tiles, queried on x = 0, so
    every nearest distance ties across two work items and the lowest
    original index must win; ``ragged``: 61-point scene tiles, not a
    multiple of the points a thread holds."""
    model = _cloud(5, 3000).to(dev)
    tn, n = (61, 61 * 17) if case == "ragged" else (128, 1024)
    scene = (_cloud(6, n) * 1.01).to(dev)
    if case == "duplicates":
        half = model[:1024] * torch.tensor([3.0, 1.0, 1.0], device=dev)
        model = torch.cat([half, half * torch.tensor([-1.0, 1.0, 1.0], device=dev)])
        scene = half + 1e-3 * _cloud(7, 1024).to(dev)
        scene[:, 0] = 0.0
    grid = nn_grid.build_model_grid(model, target_tile=256)
    u = nn_grid.bound_from_indices(scene, grid, nn_grid.initial_bound_indices(scene, model))
    cand, counts, _ = nn_grid.candidates(scene, u, grid, scene_tile=tn, cap=cap)
    if case == "straggler":
        cand[:, 0] = torch.arange(cand.shape[0], device=dev) % grid.tiles.shape[0]
        counts.fill_(1)
        counts[3] = cap + 1
    args = (cand, counts, scene, grid.tiles, tn)
    before = _build.LAUNCHES["nn_grid"]
    dk, ik, yk, _ = nn_grid.nn_grid(*args, kd_row=grid.kd_row)
    assert _build.LAUNCHES["nn_grid"] == before + 1
    dp, ip, yp, _ = nn_grid.nn_grid_plain(*args, kd_row=grid.kd_row)
    assert torch.equal(ik, ip) and torch.equal(dk, dp) and torch.equal(yk, yp)
    assert torch.equal(yk, model[ik.long()])
    if case == "straggler":  # only the tile that folds every tile is exact
        rows = slice(3 * tn, 4 * tn)
        assert torch.equal(ik[rows], nn_dense.nn_dense(scene[rows].contiguous(), model))
    else:
        assert torch.equal(ik, nn_dense.nn_dense(scene, model))
    if case == "duplicates":
        tile = grid.kd_row.long() // grid.model_tile
        assert (tile[:1024] != tile[1024:]).all()
        assert int(ik.max()) < 1024


@pytest.mark.parametrize("cap", [16, 1])
def test_nn_grid_payload_matches_plain(dev, cap):
    model = _cloud(7, 3000).to(dev)
    normals = _cloud(8, 3000).to(dev)
    scene = (_cloud(9, 1024) * 1.01).to(dev)
    grid = nn_grid.build_model_grid(model, target_tile=256, payload=normals)
    u = nn_grid.bound_from_indices(scene, grid, nn_grid.initial_bound_indices(scene, model))
    cand, counts, _ = nn_grid.candidates(scene, u, grid, scene_tile=128, cap=cap)
    args = (cand, counts, scene, grid.tiles, 128, grid.payload)
    before = _build.LAUNCHES["nn_grid"]
    dk, ik, yk, pk = nn_grid.nn_grid(*args, kd_row=grid.kd_row)
    assert _build.LAUNCHES["nn_grid"] == before + 1
    dp, ip, yp, pp = nn_grid.nn_grid_plain(*args, kd_row=grid.kd_row)
    assert torch.equal(ik, ip) and torch.equal(yk, yp) and torch.equal(pk, pp)
    assert torch.equal(pk[:, :3], normals[ik.long()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qcp_rotation_from_kernel_matches_plain(dev, dtype):
    """K5 on S, gp and gy as the caller holds them: (R in S's dtype, q,
    lambda) bit-equal to the plain version and to the packed entry's plain
    version, one launch a call."""
    rng = np.random.default_rng(11)
    for _ in range(8):
        S = torch.tensor(rng.standard_normal((3, 3)), dtype=dtype)
        gp, gy = (torch.tensor(rng.uniform(0.5, 4.0), dtype=dtype) for _ in range(2))
        before = _build.LAUNCHES["qcp_rotation"]
        R, q, lam = qcp.qcp_rotation_from(S.to(dev), gp.to(dev), gy.to(dev))
        assert _build.LAUNCHES["qcp_rotation"] == before + 1
        assert R.dtype == dtype and q.dtype == lam.dtype == torch.float64
        want = qcp.qcp_rotation_from_plain(S, gp, gy)
        for a, b in zip((R, q, lam), want):
            assert torch.equal(a.cpu(), b)
        packed = qcp.qcp_rotation_plain(qcp.pack_rotation_input(S, gp, gy))
        assert torch.equal(R.cpu(), packed[0, :9].reshape(3, 3).to(dtype))


def test_cli_bcast_qcp_fused_takes_k5_every_iteration(dev, tmp_path):
    """The cow_tr1 CLI case with ``--nn bcast --solver qcp_fused``: 7
    iterations, each through K5 (and no other kernel), its trace within
    rtol 1e-2 of the reference binary's on entries > 1e-6."""
    import contextlib
    import io
    import re

    from icp_tpu_torch.engine.cli import main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(root, "data")
    err = io.StringIO()
    _build.reset_counts()
    with contextlib.redirect_stderr(err):
        rc = main([os.path.join(data, "cow_ref.txt"), os.path.join(data, "cow_tr1.txt"), "10",
                   "--nn", "bcast", "--solver", "qcp_fused", "--device", "cuda",
                   "--output", str(tmp_path / "output.txt")])
    assert rc == 0
    trace_re = re.compile(r"\[ICP\] iteration number (\d+) \| error value = (\S+)")
    got = [float(e) for _, e in trace_re.findall(err.getvalue())]
    with open(os.path.join(root, "tests", "fixtures", "reference", "cow_tr1_stderr.txt")) as f:
        want = [float(e) for _, e in trace_re.findall(f.read())]
    assert len(got) == len(want) == 7
    assert _build.LAUNCHES["qcp_rotation"] == 7 and sum(_build.LAUNCHES.values()) == 7
    big = np.array(want) > 1e-6
    np.testing.assert_allclose(np.array(got)[big], np.array(want)[big], rtol=1e-2)


def test_qcp_rotation_kernel_matches_plain(dev):
    rng = np.random.default_rng(10)
    S = torch.tensor(rng.standard_normal((3, 3)), dtype=torch.float64)
    packed = qcp.pack_rotation_input(S, torch.tensor(3.0, dtype=torch.float64),
                                     torch.tensor(2.5, dtype=torch.float64))
    before = _build.LAUNCHES["qcp_rotation"]
    out = qcp.qcp_rotation(packed.to(dev))
    assert _build.LAUNCHES["qcp_rotation"] == before + 1
    torch.testing.assert_close(out.cpu(), qcp.qcp_rotation_plain(packed), rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,m,k", [(1, 17, 17), (700, 2049, 5), (3000, 1500, 17), (300, 900, 32),
                                   (500, 1000, 1), (257, 20, 17), (129, 1001, 32),
                                   ("lattice", None, 17), (300, 900, 33), (4096, 4096, 64),
                                   (129, 1001, 128), (70, 128, 128), ("lattice", None, 64),
                                   ("lattice", None, 128)])
def test_knn_dense_kernel_matches_plain(dev, n, m, k):
    """k 1, 17 and 32 (one slot a lane), 33 and 64 (two) and 128 (four); m <
    32, m not a multiple of 32 and m = k; ``lattice``: an
    integer lattice, every point twice, queried at its sites and half-way
    between them, so many distances are exactly equal."""
    if n == "lattice":
        g = np.arange(8, dtype=np.float32)
        lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        p = torch.tensor(np.concatenate([lattice[::-1], lattice])).to(dev)
        q = torch.tensor(np.concatenate([lattice[::3], lattice[::5] + 0.5])).to(dev)
    else:
        q, p = _cloud(n + 1, n).to(dev), _cloud(m + 2, m, 1.5).to(dev)
        p[m // 2:] = p[: m - m // 2].clone()  # duplicates: lowest index wins
    before = _build.LAUNCHES["knn_dense"]
    dk, ik = knn_dense.knn_dense(q, p, k)
    assert _build.LAUNCHES["knn_dense"] == before + 1
    dp, ip = knn_dense.knn_dense_plain(q, p, k)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


@pytest.mark.parametrize("k,cap", [(17, 32), (8, 1), (33, 32), (64, 32), (64, 1), (128, 32)])
def test_knn_grid_kernel_matches_plain_and_dense(dev, k, cap):
    pts = _cloud(11, 5000).to(dev)
    grid = nn_grid.build_model_grid(pts, target_tile=256)
    query = pts[torch.randperm(5000, generator=torch.Generator().manual_seed(0))[:1800]]
    before = _build.LAUNCHES["knn_grid"]
    dk, ik = knn_grid.knn_grid(query, grid, k, scene_tile=64, max_candidates=cap)
    assert _build.LAUNCHES["knn_grid"] == before + 2  # seed pass + exact pass
    dd, idd = knn_dense.knn_dense(query.contiguous(), pts, k)
    assert torch.equal(ik, idd) and torch.equal(dk, dd)
    cand = torch.zeros((1800 // 60, 4), dtype=torch.int32, device=dev)
    cand[:, 1] = 1
    cand[:, 2] = grid.tiles.shape[0] - 1
    counts = torch.full((1800 // 60,), 3, dtype=torch.int32, device=dev)
    counts[::5] = 99  # some tiles fold every tile
    args = (cand, counts, query.contiguous(), grid.tiles, 60, k)
    assert all(torch.equal(a, b) for a, b in zip(knn_grid.knn_worklist(*args),
                                                 knn_grid.knn_worklist_plain(*args)))


def _k7_tables(pts, query, k, cap, tn=64):
    grid = nn_grid.build_model_grid(pts, target_tile=128)
    bd2 = nn_grid.tile_box_dists(query, grid, scene_tile=tn)
    d_seed, _ = knn_grid.knn_worklist(*knn_grid.seed_table(bd2, k, grid.model_tile), query,
                                      grid.tiles, tn, k)
    kth = d_seed[:, k - 1].contiguous()
    return grid, knn_grid.cull_table(bd2, kth, tn, cap), kth


@pytest.mark.parametrize("case", ["straggler", "duplicates"])
def test_knn_worklist_kernel_with_and_without_the_bound(dev, case):
    """K7's exact pass equals its plain version with the seed bound and
    without it.  ``straggler``: capacity 1, so the query tiles past it fold
    all 128 tiles, cut into work items whose partial lists the merge joins;
    ``duplicates``: 2,048 points and their mirror images across x = 0 (other
    kd tiles), queried on that plane, so every distance ties across two
    work items and the lowest original index must win."""
    _worklist_case(dev, case, 17)


@pytest.mark.parametrize("case", ["straggler", "duplicates"])
@pytest.mark.parametrize("k", [33, 64, 128])
def test_knn_worklist_kernel_long_lists(dev, case, k):
    """The same cases with lists of two and four slots a lane."""
    _worklist_case(dev, case, k)


def _worklist_case(dev, case, k):
    from icp_tpu_torch.engine.grid import _prepare_scene

    if case == "straggler":
        pts = _cloud(13, 20000).to(dev)
        cap = 1
    else:
        half = _cloud(14, 2048).to(dev) * torch.tensor([3.0, 1.0, 1.0], device=dev)
        pts = torch.cat([half, half * torch.tensor([-1.0, 1.0, 1.0], device=dev)])
        cap = 32
    query, _, _, tn, _ = _prepare_scene(pts[:4096] if case == "straggler" else pts[:2048], 64)
    query = query.contiguous()
    if case == "duplicates":
        query[:, 0] = 0.0
    grid, (cand, counts), kth = _k7_tables(pts, query, k, cap, tn)
    nj = grid.tiles.shape[0]
    first, slots = knn_grid.knn_work_items(counts, cap, nj)
    if case == "straggler":
        over = counts > cap
        assert nj == 128 and bool(over.any())
        per = knn_grid.item_tiles(nj)[1]
        assert per < nj and bool(((first[1:] - first[:-1])[over] == -(-nj // per)).all())
    else:
        tile = grid.kd_row.long() // grid.model_tile
        assert (tile[:2048] != tile[2048:]).all()
    assert int(slots[-1]) > 0  # some lists are merged from partial lists
    args = (cand, counts, query, grid.tiles, tn, k)
    want = knn_grid.knn_worklist_plain(*args, bound=kth)
    before = _build.LAUNCHES["knn_grid"]
    for kb in (kth, None):
        got = knn_grid.knn_worklist(*args, bound=kb)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _build.LAUNCHES["knn_grid"] == before + 2
    d2, idx = knn_grid.knn_grid(query, grid, k, scene_tile=tn, max_candidates=cap)
    dd, di = knn_dense.knn_dense(query, pts, k)
    assert torch.equal(idx, di) and torch.equal(d2, dd)
    if case == "duplicates":
        assert torch.equal(di[:, 0] % 2048, di[:, 1] % 2048) and bool((di[:, 0] < 2048).all())


@pytest.mark.parametrize("n,m", [(1, 1), (37, 31), (300, 2049), (5000, 700)])
def test_nn_chunked_kernel_matches_plain_and_k1(dev, n, m):
    s, mo = _cloud(n + 3, n).to(dev), _cloud(m + 4, m, 2.0).to(dev)
    mo[m // 2:] = mo[: m - m // 2].clone()  # duplicates on other lanes: lowest index wins
    before = _build.LAUNCHES["nn_chunked"]
    ik = nn_dense.nn_dense(s, mo, distance_impl="chunked")
    assert _build.LAUNCHES["nn_chunked"] == before + 1
    assert torch.equal(ik, nn_dense.nn_chunked_plain(s, mo))
    assert torch.equal(ik, nn_dense.nn_dense(s, mo))


def _chunked_case(dev, case):
    """(scene, model, the lowest row of each tie set) of a K8 case."""
    if case == "m1":
        return _cloud(1, 700).to(dev), _cloud(2, 1, 2.0).to(dev)
    if case == "m31":
        return _cloud(3, 700).to(dev), _cloud(4, 31, 2.0).to(dev)
    n, m = (700, 3001) if case != "cow" else (2903, 2903)
    s, mo = _cloud(n + 5, n).to(dev), _cloud(m + 6, m, 2.0).to(dev)
    chunk = nn_dense.chunked_chunk_rows(n, m)
    assert -(-m // chunk) > 1 and m % chunk  # several chunks, the last partial
    if case == "ties":  # rows 0-9 again on other lanes, 32 and 96 rows and a chunk later
        for off in (17, 32, 96, chunk):
            mo[off:off + 10] = mo[:10].clone()
        s[:10] = mo[:10] + 1e-3
    elif case == "nan":  # a NaN model row in the first and in the last chunk
        mo[5, 1] = float("nan")
        mo[m - 2, 0] = float("nan")
        s[3, 2] = float("nan")
    return s, mo


@pytest.mark.parametrize("case", ["ties", "nan", "m1", "m31", "partial", "cow"])
def test_nn_chunked_kernel_across_model_chunks(dev, case):
    """K8's model chunks merge by the lowest index of the least distance:
    ties across lanes and chunks go to the lowest row, a NaN never wins (a
    NaN scene row gets index 0), m = 1 and m < 32 leave lanes without rows;
    three launches in a row give the same indices, each one launch, and the
    merge workspace is clean after each."""
    s, mo = _chunked_case(dev, case)
    keys, counts = nn_dense.chunked_workspace(dev)
    assert nn_dense.chunked_workspace(s.device)[0] is keys  # the one the launches use
    want = nn_dense.nn_chunked_plain(s, mo)
    assert torch.equal(want, nn_dense.nn_dense(s, mo))
    for _ in range(3):
        before = _build.LAUNCHES["nn_chunked"]
        ik = nn_dense.nn_dense(s, mo, distance_impl="chunked")
        assert _build.LAUNCHES["nn_chunked"] == before + 1
        assert torch.equal(ik, want)
        assert bool((keys == -1).all()) and not bool(counts.any())
    if case == "ties":
        assert torch.equal(ik[:10].cpu(), torch.arange(10, dtype=torch.int32))
    if case == "nan":
        assert int(ik[3]) == 0 and not bool(((ik == 5) | (ik == mo.shape[0] - 2)).any())


def test_nn_chunked_kernel_on_two_streams(dev):
    """K8 launched on two streams in turns, each launch splitting its model
    into chunks: each stream has its own merge workspace, so every launch
    gives the plain version's indices and both workspaces are clean after."""
    pairs = [(_cloud(21, 700).to(dev), _cloud(22, 3001, 2.0).to(dev)),
             (_cloud(23, 650).to(dev), _cloud(24, 2903, 2.0).to(dev))]
    wants = [nn_dense.nn_chunked_plain(s, mo) for s, mo in pairs]
    streams = [torch.cuda.Stream(device=dev) for _ in pairs]
    torch.cuda.synchronize()
    outs, spaces = [[], []], []
    for _ in range(20):
        for k, (st, (s, mo)) in enumerate(zip(streams, pairs)):
            with torch.cuda.stream(st):
                outs[k].append(nn_dense.nn_chunked(s, mo))
    for st in streams:
        with torch.cuda.stream(st):
            spaces.append(nn_dense.chunked_workspace(dev))
    torch.cuda.synchronize()
    assert spaces[0][0].data_ptr() != spaces[1][0].data_ptr()
    for k, want in enumerate(wants):
        assert all(torch.equal(ik, want) for ik in outs[k])
    for keys, counts in spaces:
        assert bool((keys == -1).all()) and not bool(counts.any())


def hold_k9(s, mo, got):
    """K9's outputs against its plain version: bit-equal, or, where the
    tensor cores' accumulation rounds the cross term otherwise, held to its
    promises: ``d_exact`` bit-equal to the diff-squares distance to
    ``model[idx]``; ``best`` and ``second`` within ``cross_term_slack``
    (delta) of the plain version's; the plain index wherever the plain
    margin exceeds 2 delta; certified rows equal K1; ``d_exact`` >= K1's.
    Returns the share of rows whose ``best`` is bit-equal to the plain's."""
    idx, best, second, dex = got
    ip, bp, sp, _ = nn_bf16.nn_bf16_plain(s, mo)
    delta = float(nn_bf16.cross_term_slack(s, mo))
    diff = s - mo[idx.long()]
    assert torch.equal(dex, (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
                       + diff[:, 2] * diff[:, 2])
    assert float((best - bp).abs().max()) <= delta
    assert torch.equal(torch.isinf(second), torch.isinf(sp))
    fin = torch.isfinite(sp)
    assert not bool(fin.any()) or float((second[fin] - sp[fin]).abs().max()) <= delta
    clear = (sp - bp) > 2 * delta
    assert torch.equal(idx[clear], ip[clear])
    ik1, d1 = nn_dense.nn_dense(s, mo, with_dist=True)
    cert = (second - best) > 2 * nn_bf16.cross_term_bound(s, mo)
    assert torch.equal(idx[cert], ik1[cert]) and bool((dex >= d1).all())
    return float((best == bp).double().mean())


@pytest.mark.parametrize("n,m,offset", [(1, 1, 0.0), (300, 2049, 0.0), (5000, 700, 50.0),
                                        (15, 7, 0.0), (16, 8, 0.0), (17, 9, 0.0), (500, 1, 0.0),
                                        (16, 9, 0.0), (17, 8, 0.0), (500, 3000, 0.0)])
def test_nn_bf16_kernel_matches_plain(dev, n, m, offset):
    """Scene rows 1, 15, 16, 17 and 500 (the mma's 16-row tiles), model rows
    1, 7, 8 and 9 (its 8-column tiles); the upper half of the model repeats
    the lower half, so ties on best and second fall in other chunks."""
    s, mo = (_cloud(n + 5, n) + offset).to(dev), (_cloud(m + 6, m, 2.0) + offset).to(dev)
    mo[m // 2:] = mo[: m - m // 2].clone()  # duplicates: lowest index, second == best
    before = _build.LAUNCHES["nn_bf16"]
    got = nn_bf16.nn_bf16(s, mo)
    assert _build.LAUNCHES["nn_bf16"] == before + 1
    hold_k9(s, mo, got)
    dup = got[0] < m // 2  # a winner with a copy m // 2 rows on: best == second
    assert torch.equal(got[1][dup], got[2][dup])


def test_nn_bf16_kernel_certifies_a_lattice(dev):
    """Random clouds certify nothing; beside the sites of a jittered 4^3
    lattice the margins exceed the bf16 band, so the kernel's certificate
    is held to K1 on rows that have one."""
    rng = np.random.default_rng(13)
    sites = np.stack(np.meshgrid(*[np.arange(4.0)] * 3), -1).reshape(-1, 3)
    sel = rng.integers(0, len(sites), 3000)
    mo = torch.tensor(sites + 0.01 * rng.standard_normal(sites.shape), dtype=torch.float32, device=dev)
    s = torch.tensor(sites[sel] + 0.02 * rng.standard_normal((3000, 3)), dtype=torch.float32,
                     device=dev)
    idx, _, cert = nn_bf16.closest_point_indices_bf16(s, mo)
    assert cert.double().mean() > 0.5
    assert torch.equal(idx[cert], nn_dense.nn_dense(s, mo)[cert])
    c = mo.mean(0)
    hold_k9((s - c).contiguous(), (mo - c).contiguous(), nn_bf16.nn_bf16((s - c).contiguous(),
                                                                         (mo - c).contiguous()))
    assert torch.equal(idx[cert].cpu(), torch.tensor(sel, dtype=torch.int32)[cert.cpu()])


def _surface(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    return np.column_stack([xy, 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * xy[:, 1] ** 2])


@pytest.mark.parametrize("engine", ["symmetric", "gicp"])
def test_plane_engines_grid_matches_dense_on_the_card(dev, engine):
    from icp_tpu_torch import ICPConfig, estimate_normals, icp_generalized, icp_symmetric

    model = torch.tensor(_surface(12, 6000), dtype=torch.float32, device=dev)
    a = 0.1
    R = torch.tensor([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                      [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    scene = model @ R.T + 0.02
    nm, ns = estimate_normals(model), estimate_normals(scene)
    run = icp_symmetric if engine == "symmetric" else icp_generalized
    kw = (dict(normals=nm, scene_normals=ns) if engine == "symmetric"
          else dict(model_normals=nm, scene_normals=ns))
    base = dict(max_iter=30, threshold=1e-10)
    _build.reset_counts()
    grid = run(model, scene, ICPConfig(nn_method="grid", **base), **kw)
    assert _build.LAUNCHES["nn_grid"] >= int(grid.iters) and _build.LAUNCHES["nn_dense"] >= 1
    dense = run(model, scene, ICPConfig(nn_method="pallas", **base), **kw)
    assert int(grid.iters) == int(dense.iters) > 1
    torch.testing.assert_close(grid.points, dense.points, rtol=0, atol=1e-5)


def _diverging_rows(dev):
    """(1, 18) float64 sums of a cloud and its copy moved by noise whose
    error jumps more than 100x above the least so far at the third row."""
    from icp_tpu_torch.ops.alignment import compute_alignment_stats

    rng = np.random.default_rng(0)
    rows = []
    for sigma in (0.05, 0.03, 0.6, 0.01):
        p = torch.tensor(rng.standard_normal((200, 3)), device=dev)
        y = p + sigma * torch.tensor(rng.standard_normal((200, 3)), device=dev)
        rows.append(qcp.pack_stats(compute_alignment_stats(p, y)).contiguous())
    return rows


def _same_nan(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("case", ["diverged", "nonfinite", "unguarded"])
def test_qcp_step_kernel_status_word_matches_plain(dev, case):
    """K2's guard: the status word, the least error in slot 28 and the
    state bit-equal to the plain version step by step; unguarded, the
    status stays 0 and slot 28 is written 0, as before the guard."""
    rows = _diverging_rows(dev)
    if case == "nonfinite":
        rows[1] = rows[1].clone()
        rows[1][0, 3] = float("nan")
    outs = []
    for fn in (qcp.qcp_step, qcp.qcp_step_plain):
        st, ctl, errs = qcp.identity_state(dev), qcp.new_loop_control(8, dev), qcp.new_err_buffer(8, dev)
        words = []
        for r in rows:
            fn(r, st, ctl, errs, with_scale=False, err_factor=1.0, threshold=-float("inf"),
               guard=case != "unguarded")
            words.append(ctl.tolist())
        outs.append((st, words, errs))
    (sk, wk, ek), (sp, wp, ep) = outs
    assert wk == wp and _same_nan(sk, sp) and _same_nan(ek, ep)
    if case == "diverged":
        assert wk[2] == wk[3] == [3, 1, 8, qcp.GUARD_DIVERGED]
        assert float(sk[0, qcp.BEST_SLOT]) == float(ek[1])
    elif case == "nonfinite":
        assert wk[1] == [2, 1, 8, qcp.GUARD_NONFINITE]
    else:
        assert wk[3] == [4, 0, 8, 0] and float(sk[0, qcp.BEST_SLOT]) == 0.0


def test_icp_fused_kernel_status_word_matches_plain(dev):
    """K3's last block runs K2's guarded step: a NaN scene row gives status
    1 at once, as the plain version; on a clean cloud the guarded launch
    writes the unguarded state but for slot 28 (the least error)."""
    scene, model = _cloud(31, 3000), _cloud(32, 2000)
    bad = scene.clone()
    bad[5, 1] = float("nan")
    for cloud, status in ((bad, qcp.GUARD_NONFINITE), (scene, qcp.GUARD_OK)):
        prep = icp_fused.prepare_fused_inputs(cloud.to(dev), model.to(dev))
        runs = []
        for guard in (True, False):
            st, ctl, errs = qcp.identity_state(dev), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
            icp_fused.fused_icp_step(prep, st, ctl, errs, threshold=1e-5, guard=guard)
            runs.append((st, ctl, errs))
        (st, ctl, errs), (ust, uctl, uerrs) = runs
        pst, pctl, perrs = qcp.identity_state(dev), qcp.new_loop_control(4, dev), qcp.new_err_buffer(4, dev)
        qcp.qcp_step_plain(prep.rows, pst, pctl, perrs, threshold=1e-5, guard=True)
        assert ctl.tolist() == pctl.tolist() == [1, int(status != 0), 4, status]
        assert _same_nan(st, pst) and _same_nan(errs, perrs)
        assert _same_nan(st[0, :qcp.BEST_SLOT], ust[0, :qcp.BEST_SLOT]) and _same_nan(errs, uerrs)
        assert uctl.tolist()[3] == 0 and float(ust[0, qcp.BEST_SLOT]) == 0.0


@pytest.mark.parametrize("bucketed", [False, True], ids=["trimmed", "trimmed_bucketed"])
def test_trimmed_loop_launches_one_k1_and_one_k2_an_iteration(dev, bucketed):
    """The trimmed cow loop takes the pipeline: a K1 and a K2 launch each
    launched iteration (whole chunks of 8), no K3, 8 iterations as the JAX
    fixture; bucket padding (4,096 rows) changes neither."""
    from icp_tpu_torch import ICPConfig, icp
    from icp_tpu_torch.engine.icp import _CHUNK
    from icp_tpu_torch.io.csv import load_matrix
    from icp_tpu_torch.ops.padding import pad_to_bucket

    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
    ref, tr1 = (load_matrix(os.path.join(data, f)) for f in ("cow_ref.txt", "cow_tr1.txt"))
    kw = {}
    if bucketed:
        (ref, m_n), (tr1, s_n) = pad_to_bucket(ref), pad_to_bucket(tr1)
        kw = dict(scene_n=s_n, model_n=m_n)
    _build.reset_counts()
    res = icp(ref, tr1, ICPConfig(max_iter=30, trim_fraction=0.1), **kw)
    iters = int(res.iters)
    launched = min(30, -(-iters // _CHUNK) * _CHUNK)
    assert iters == 8
    assert _build.LAUNCHES["nn_dense"] == _build.LAUNCHES["qcp_step"] == launched
    assert _build.LAUNCHES["icp_fused"] == 0


@pytest.mark.parametrize("bucketed", [False, True], ids=["fused", "bucketed_pipeline"])
def test_batched_pallas_path_is_each_pairs_own_run(dev, bucketed):
    """``icp_batched(nn_method="pallas", solver="qcp_fused")`` on 4 pairs, 6
    iterations: unmasked pairs take K3, one launch an iteration (4 x 6 and
    no K1 or K2); bucket-padded ones K1 + K2 (4 x 6 each, no K3); each pair
    bit-equal to its own ``icp_fixed_iters``."""
    from icp_tpu_torch.engine.batched import batch_pairs, icp_batched
    from icp_tpu_torch.engine.icp import icp_fixed_iters

    rng = np.random.default_rng(21)
    pairs = []
    for b in range(4):
        m = rng.standard_normal((900 + 50 * b * bucketed, 3)).astype(np.float32)
        th = 0.05 * (b + 1)
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        pairs.append((m, (m @ R.T + 0.05 * b).astype(np.float32)))
    if bucketed:
        models, scenes, m_ns, s_ns = batch_pairs(pairs, quantum=512)
    else:
        models, scenes = np.stack([m for m, _ in pairs]), np.stack([s for _, s in pairs])
        m_ns = s_ns = None
    kw = dict(n_iters=6, solver="qcp_fused", nn_method="pallas")
    _build.reset_counts()
    res = icp_batched(models, scenes, scene_ns=s_ns, model_ns=m_ns, device=dev, **kw)
    used = dict(_build.LAUNCHES)
    if bucketed:
        assert used["nn_dense"] == used["qcp_step"] == 24 and used["icp_fused"] == 0
    else:
        assert used["icp_fused"] == 24 and used["nn_dense"] == used["qcp_step"] == 0
    for b in range(4):
        one = icp_fixed_iters(models[b], scenes[b], device=dev,
                              scene_n=None if s_ns is None else int(s_ns[b]),
                              model_n=None if m_ns is None else int(m_ns[b]), **kw)
        assert torch.equal(res.points[b], one.points) and torch.equal(res.err[b], one.err)
        assert all(torch.equal(a[b], c) for a, c in zip(res.transform, one.transform))
