"""Metropolis building blocks shared by the samplers (port of the parts of
cosmomc_tpu/sampling/metropolis.py the staged sampler uses): the rejection
sentinel, the per-segment output record, and the bounded-posterior wrapper
(calclike.f90 GetLogLikeBounds + GetLogPriors), batched over chains."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

LOG_ZERO = 1e30   # rejection sentinel (reference settings.f90:114)


class SegmentOutput(NamedTuple):
    accept: torch.Tensor      # (S, C) bool
    P: torch.Tensor           # (S, C, n) current point AFTER each step
    mloglike: torch.Tensor    # (S, C)
    derived: torch.Tensor     # (S, C, nd)
    #: the proposed point was in bounds but its theory was non-finite
    error: torch.Tensor       # (S, C) bool


def prior_and_bounds(P: torch.Tensor, pa: Dict[str, torch.Tensor]):
    """(Gaussian + linear prior chi^2/2, in-bounds mask), per chain."""
    inb = torch.all((P >= pa["lo"]) & (P <= pa["hi"]), dim=-1)
    t = (P - pa["prior_mean"]) / pa["prior_std"]
    prior = 0.5 * torch.sum(torch.where(pa["has_prior"], t * t, 0.0), -1)
    if pa["lin_w"].shape[0] > 0:
        s = (P @ pa["lin_w"].T - pa["lin_mean"]) / pa["lin_std"]
        prior = prior + 0.5 * torch.sum(s * s, -1)
    return prior, inb


def mask_posterior(m: torch.Tensor, d: torch.Tensor, prior: torch.Tensor,
                   inb: torch.Tensor, dtype):
    """Apply bounds and priors to raw (-logL, derived): out of bounds ->
    LOG_ZERO; in bounds but non-finite (an error point) -> 2 LOG_ZERO."""
    bad = torch.isnan(m) | (m >= LOG_ZERO * 0.1)
    ok = inb & ~bad
    err = inb & bad
    mout = torch.where(ok, m + prior,
                       torch.where(err, 2.0 * LOG_ZERO, LOG_ZERO)).to(dtype)
    return mout, torch.where(ok[:, None], d.to(dtype), 0.0), err


def make_bounded_posterior(logpost_fn: Callable, lo: torch.Tensor,
                           hi: torch.Tensor,
                           prior_arrays: Optional[Dict[str, torch.Tensor]] = None,
                           num_derived: int = 0) -> Callable:
    """Wrap a raw (C, n) -> (-logL (C,), derived (C, nd)) function with hard
    bounds and Gaussian/linear priors. Out-of-bounds points evaluate the
    theory at the clipped point and are masked to LOG_ZERO."""
    pa = dict(prior_arrays or {})
    pa["lo"], pa["hi"] = lo, hi

    def bounded(P):
        m, d = logpost_fn(torch.clamp(P, lo, hi))
        prior, inb = prior_and_bounds(P, pa)
        mout, dout, _ = mask_posterior(m, d, prior, inb, P.dtype)
        return mout, dout
    return bounded
