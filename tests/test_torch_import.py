"""The port stands alone: it imports neither JAX nor ``icp_tpu``."""

import ast
import os
import subprocess
import sys

import icp_tpu_torch

PKG = os.path.dirname(icp_tpu_torch.__file__)
REPO = os.path.dirname(PKG)


def test_import_leaves_jax_out():
    code = ("import sys, icp_tpu_torch, icp_tpu_torch.engine.cli, icp_tpu_torch.engine.grid, "
            "icp_tpu_torch.engine.point_to_plane, icp_tpu_torch.engine.symmetric, "
            "icp_tpu_torch.engine.gicp, icp_tpu_torch.kernels.nn_bf16, "
            "icp_tpu_torch.kernels.knn_grid, "
            "icp_tpu_torch.utils.convert, icp_tpu_torch.engine.batched, "
            "icp_tpu_torch.engine.global_reg, icp_tpu_torch.slam.cli, "
            "icp_tpu_torch.slam.closure, icp_tpu_torch.bench.harness, "
            "icp_tpu_torch.bench.roofline, icp_tpu_torch.bench.scaling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'icp_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_module_of_the_port_imports_jax_or_icp_tpu():
    """Every module of the package, and the port's scripts at the root:
    ``chip_smoke.py`` and ``bench_torch.py``."""
    paths = [os.path.join(REPO, name) for name in ("chip_smoke.py", "bench_torch.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            offenders += [(path, m) for m in mods
                          if m.split(".")[0] in ("jax", "jaxlib", "icp_tpu")]
    assert not offenders, offenders


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    csrc = os.path.join(PKG, "csrc")
    for name, replaced in (("nn_dense.cu", "nn_pallas.py:99 _nn_kernel"),
                           ("qcp.cu", "qcp_pallas.py:122 _alignment_step_kernel"),
                           ("icp_fused.cu", "icp_fused.py:128 _icp_iter_kernel"),
                           ("nn_grid.cu", "nn_grid.py:240 _pruned_kernel"),
                           ("qcp.cu", "qcp_pallas.py:32 _qcp_kernel"),
                           ("knn_dense.cu", "knn_pallas.py:59 _knn_kernel"),
                           ("knn_grid.cu", "knn_grid.py:53 _knn_worklist_kernel"),
                           ("nn_chunked.cu", "nn_pallas.py:49 _nn_kernel_chunked"),
                           ("nn_bf16.cu", "nn_bf16.py:60 _nn_bf16_kernel")):
        with open(os.path.join(csrc, name)) as f:
            head = f.read(4000)
        assert f"icp_tpu/kernels/{replaced}" in head, name
        assert "What bounds it on the H100" in head, name
