# How far a hand-written kernel's output lies from its plain version's, the
# one check every kernel of the port is held to.  Each kernel's ``ref.py``
# states its own limits (``KERNEL_TOL``) and calls ``agreement`` with them.
from __future__ import annotations

import torch


def agreement(got: torch.Tensor, want: torch.Tensor, tol: dict, scale: torch.Tensor = None) -> dict:
    """``got`` against ``want`` under ``tol`` = dict(rtol, atol_frac, rel,
    and optionally floor_frac and scale_frac).  Per element, |got - want| <=
    rtol * |want| + atol_frac * rms(want's row) + floor_frac * rms(want) +
    scale_frac * ``scale`` (when given: the sum of the magnitudes of the
    terms that ``want`` sums, against which a float sum's rounding is
    measured where the terms cancel), a row being the
    last axis; over the whole tensor, ||got - want|| / ||want|| <= rel; and
    every element of ``got`` finite.  ``ok`` when all
    hold; ``worst`` is the largest |got - want| over its per-element limit
    (at most 1 when ok), ``rel`` the relative Frobenius error,
    ``max_abs_err`` the largest difference.  Computed in float64, so that
    the rms of a row of tiny values (a gradient scaled by e^{-54.6}) does
    not underflow to 0 as its squares would in f32."""
    if want.numel() == 0:
        return dict(ok=True, worst=0.0, rel=0.0, max_abs_err=0.0)
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    limit = tol["rtol"] * w.abs() + tol["atol_frac"] * w.square().mean(dim=-1, keepdim=True).sqrt()
    if tol.get("floor_frac"):
        limit = limit + tol["floor_frac"] * w.square().mean().sqrt()
    if scale is not None and tol.get("scale_frac"):
        limit = limit + tol["scale_frac"] * scale.double()
    worst = float(torch.where(diff == 0, 0.0, diff / limit).max())
    finite = bool(torch.isfinite(g).all())
    norm_w, norm_d = float(torch.linalg.vector_norm(w)), float(torch.linalg.vector_norm(diff))
    rel = norm_d / norm_w if norm_w > 0 else (0.0 if norm_d == 0 else float("inf"))
    return dict(ok=finite and worst <= 1.0 and rel <= tol["rel"], worst=worst, rel=rel,
                max_abs_err=float(diff.max()))
