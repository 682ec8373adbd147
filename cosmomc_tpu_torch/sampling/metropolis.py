"""Vectorised Metropolis-Hastings with blocked proposals (port of
cosmomc_tpu/sampling/metropolis.py; reference source/MCMC.f90).

One chain per row of a (C, n) batch. A trial is accepted with probability
exp(-(trial - current)/T) in -logL units (MetropolisAccept, MCMC.f90:119-131);
every chain follows one host-built proposal schedule. Also here: the
rejection sentinel, the per-segment output record, and the bounded-posterior
wrapper (calclike.f90 GetLogLikeBounds + GetLogPriors) that the staged
sampler shares.

The posterior is batched, (C, n) -> (-logL (C,), derived (C, nd)).
Randomness comes from the sampler's own `torch.Generator`, drawn a segment
at a time (`draw_segment`); a caller may pass the draws in instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.sampling.proposal import (BlockedProposal,
                                                 ProposalSchedule,
                                                 propose_radius)

LOG_ZERO = 1e30   # rejection sentinel (reference settings.f90:114)


class ChainState(NamedTuple):
    P: torch.Tensor            # (C, n) current points
    mloglike: torch.Tensor     # (C,) current -logL (priors included)
    derived: torch.Tensor      # (C, nd)
    num_accept: torch.Tensor   # (C,) int32
    mapping: torch.Tensor      # (n, n) proposal mapping


class SegmentDraws(NamedTuple):
    """Every random number one segment uses."""
    deltas: torch.Tensor       # (S, C, n) unit-radius proposal directions
    radius: torch.Tensor       # (S, C) radius-mixture draws
    u_accept: torch.Tensor     # (S, C) Exp(1) acceptance draws


class SegmentOutput(NamedTuple):
    accept: torch.Tensor      # (S, C) bool
    P: torch.Tensor           # (S, C, n) current point AFTER each step
    mloglike: torch.Tensor    # (S, C)
    derived: torch.Tensor     # (S, C, nd)
    #: the proposed point was in bounds but its theory was non-finite
    error: torch.Tensor       # (S, C) bool


def prior_and_bounds(P: torch.Tensor, pa: Dict[str, torch.Tensor]):
    """(Gaussian + linear prior chi^2/2, in-bounds mask), per chain; the
    priors of `pa` that are absent count as none."""
    inb = torch.all((P >= pa["lo"]) & (P <= pa["hi"]), dim=-1)
    prior = torch.zeros_like(P[:, 0])
    if "has_prior" in pa:
        t = (P - pa["prior_mean"]) / pa["prior_std"]
        prior = prior + 0.5 * torch.sum(torch.where(pa["has_prior"], t * t, 0.0), -1)
    if "lin_w" in pa and pa["lin_w"].shape[0] > 0:
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
    val = m + prior
    # the sentinels in the values' own dtype (a where of two Python floats
    # would round them to float32 first)
    sentinel = torch.full_like(val, LOG_ZERO).masked_fill(err, 2.0 * LOG_ZERO)
    mout = torch.where(ok, val, sentinel).to(dtype)
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


def draw_segment(proposal: BlockedProposal, gen: torch.Generator,
                 schedule: ProposalSchedule, nchains: int,
                 mapping: torch.Tensor, dtype) -> SegmentDraws:
    """Directions, radii and acceptance draws for one segment, in the order
    both samplers draw them."""
    device = mapping.device
    deltas = proposal.segment_deltas(gen, nchains, schedule, mapping, dtype)
    m2 = torch.as_tensor(proposal.schedule_radius_dims(schedule), device=device)
    radius = torch.stack([propose_radius(gen, m2[t], nchains, dtype, device)
                          for t in range(len(schedule.block))])
    u = torch.empty(len(schedule.block), nchains, dtype=dtype,
                    device=device).exponential_(generator=gen)
    return SegmentDraws(deltas, radius, u)


def accept_step(mll_t: torch.Tensor, cur_mll: torch.Tensor,
                u: torch.Tensor, temperature: float) -> torch.Tensor:
    """Per-chain Metropolis decision in -logL units (MCMC.f90:119-131): a
    finite trial is taken if better, else when the Exp(1) draw `u` exceeds
    the tempered increase."""
    dl = (mll_t - cur_mll) / temperature
    return (mll_t < LOG_ZERO * 0.1) & ((mll_t < cur_mll) | (u > dl))


@dataclass
class MetropolisSampler:
    """Metropolis over a batched posterior (P (C, n) -> (-logL, derived)),
    a segment of S steps at a time."""
    proposal: BlockedProposal
    logpost_fn: Callable
    num_derived: int = 0
    temperature: float = 1.0
    seed: int = 0
    #: "cuda" (the default) or "cpu"; without a card only "cpu" is accepted
    device: Any = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = kernels.entry_device(self.device, "MetropolisSampler")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def _mapping(self) -> torch.Tensor:
        return self.proposal.mapping.to(self.device)

    def init_state(self, P0) -> ChainState:
        P0 = torch.as_tensor(P0, dtype=self.dtype, device=self.device)
        mll, der = self.logpost_fn(P0)
        return ChainState(P0, mll, der,
                          torch.zeros(P0.shape[0], dtype=torch.int32,
                                      device=self.device),
                          self._mapping())

    def draw_segment(self, schedule: ProposalSchedule, nchains: int,
                     mapping: torch.Tensor) -> SegmentDraws:
        return draw_segment(self.proposal, self.generator, schedule, nchains,
                            mapping, self.dtype)

    def step(self, state: ChainState, delta: torch.Tensor,
             radius: torch.Tensor, u: torch.Tensor):
        trial = self.proposal.propose_step(state.P, delta, radius)
        mll_t, der_t = self.logpost_fn(trial)
        acc = accept_step(mll_t, state.mloglike, u, self.temperature)
        P = torch.where(acc[:, None], trial, state.P)
        mll = torch.where(acc, mll_t, state.mloglike)
        der = torch.where(acc[:, None], der_t, state.derived)
        new = ChainState(P, mll, der, state.num_accept + acc.to(torch.int32),
                         state.mapping)
        # an error point: in bounds, but the theory evaluated non-finite
        return new, (acc, P, mll, der, mll_t >= LOG_ZERO * 1.5)

    def run_segment(self, state: ChainState, schedule: ProposalSchedule,
                    draws: Optional[SegmentDraws] = None
                    ) -> Tuple[ChainState, SegmentOutput]:
        if draws is None:
            draws = self.draw_segment(schedule, state.P.shape[0], state.mapping)
        outs = []
        for t in range(len(schedule.block)):
            state, out = self.step(state, draws.deltas[t], draws.radius[t],
                                   draws.u_accept[t])
            outs.append(out)
        return state, SegmentOutput(*[torch.stack(v) for v in zip(*outs)])
