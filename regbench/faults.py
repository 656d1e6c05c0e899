"""Faults planted under the timed path, each a wrapper of the program's
public entry: a run with one installed has to come out not correct.

* ``unchanged``: a registration that returns its state as it found it;
* ``half_rows``: half of the scene's rows left out, the mean taken over
  the rest;
* ``altered_transform``: the answer altered where it is produced (the
  translation, by 1e-3);
* ``altered_err``: the same for the reported error (by 1%).
"""

from __future__ import annotations

import dataclasses


def _unchanged(real):
    from icp_tpu_torch.ops.transform import identity_similarity

    def entry(model, scene, cfg, **kw):
        res = real(model, scene, cfg, **kw)
        return res._replace(points=scene.clone(),
                            transform=identity_similarity(scene.dtype, scene.device))
    return entry


def _half_rows(real):
    from icp_tpu_torch.ops.transform import apply_similarity

    def entry(model, scene, cfg, **kw):
        half = scene.shape[0] // 2
        res = real(model, scene[:half], dataclasses.replace(cfg, validate_inputs=False), **kw)
        return res._replace(points=apply_similarity(scene, res.transform))
    return entry


def _altered_transform(real):
    def entry(model, scene, cfg, **kw):
        res = real(model, scene, cfg, **kw)
        tr = res.transform
        return res._replace(transform=tr._replace(t=tr.t + 1e-3))
    return entry


def _altered_err(real):
    def entry(model, scene, cfg, **kw):
        res = real(model, scene, cfg, **kw)
        return res._replace(err=res.err * 1.01)
    return entry


FAULTS = {"unchanged": _unchanged, "half_rows": _half_rows,
          "altered_transform": _altered_transform, "altered_err": _altered_err}


def install(name: str, entry: str):
    """Put fault ``name`` under the program's entry ``entry``; returns a
    function that takes it out again."""
    import icp_tpu_torch

    real = getattr(icp_tpu_torch, entry)
    setattr(icp_tpu_torch, entry, FAULTS[name](real))
    return lambda: setattr(icp_tpu_torch, entry, real)
