"""Fast/slow staged Metropolis: reuse cached theory across step classes.

Port of cosmomc_tpu/sampling/staged.py (CalcLike_Cosmology.f90
:59-94 + Calculator_CAMB.f90 two-stage compute): a proposal that moves only

  SLOW params      -> full Boltzmann solve (new transfers)
  SEMISLOW params  -> primordial re-application to cached transfers
  FAST nuisance    -> likelihood re-evaluation on the cached C_l

Every chain of a batch follows one host-built schedule, so each step has
one class, known on the host: the sampler branches in Python. The
per-chain caches are dicts of tensors with a leading chains axis; accepted
chains take the trial's cache entries with `torch.where`.

Randomness comes from the sampler's own `torch.Generator`, drawn for a
whole segment in one place (`draw_segment`); a caller may pass the draws
in instead (`run_segment(..., draws=...)`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cosmomc_tpu_torch.params.space import Speed
from cosmomc_tpu_torch.sampling.metropolis import (LOG_ZERO, SegmentDraws,
                                                   SegmentOutput, accept_step,
                                                   draw_segment,
                                                   mask_posterior,
                                                   prior_and_bounds)
from cosmomc_tpu_torch.sampling.proposal import (BlockedProposal,
                                                 ProposalSchedule)

# step classes (what to recompute)
CLS_SLOW, CLS_SEMI, CLS_FAST = 0, 1, 2

#: NamedTuple fields that hold grids shared by all chains (no chains axis):
#: the C_l and tensor transfer caches' ls, kf, wk, the distance tables'
#: lz_grid, the matter transfers' and P(k, z) tables' k and z
SHARED_FIELDS = frozenset({"ls", "kf", "wk", "lz_grid", "k", "z"})


class StagedChainState(NamedTuple):
    P: torch.Tensor            # (C, n)
    mloglike: torch.Tensor     # (C,)
    derived: torch.Tensor      # (C, nd)
    num_accept: torch.Tensor   # (C,) int32
    mapping: torch.Tensor      # (n, n) proposal mapping
    slow: Any                  # per-chain slow-stage cache
    semi: Any                  # per-chain semi-stage cache


def select_chains(acc: torch.Tensor, new, old):
    """Per-chain `where(acc, new, old)` over a cache: tensors with a leading
    chains axis, dicts, NamedTuples and dataclasses of them; grids shared by
    all chains (SHARED_FIELDS) and None pass through from `new`."""
    if new is None:
        return None
    if torch.is_tensor(new):
        mask = acc.reshape(acc.shape + (1,) * (new.dim() - 1))
        return torch.where(mask, new, old)
    if isinstance(new, dict):
        return {k: select_chains(acc, new[k], old[k]) for k in new}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*[n if f in SHARED_FIELDS else
                           select_chains(acc, n, o)
                           for f, n, o in zip(new._fields, new, old)])
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: select_chains(acc, getattr(new, f.name), getattr(old, f.name))
            for f in dataclasses.fields(new)
            if torch.is_tensor(getattr(new, f.name))})
    return new


@dataclass
class StagedMetropolisSampler:
    """Metropolis over a staged posterior (pipeline.CMBPosterior)."""
    proposal: BlockedProposal
    post: Any               # exposes embed_full/stage_slow/stage_semi/stage_fast
    temperature: float = 1.0
    seed: int = 0

    def __post_init__(self):
        self.device = self.post.device
        self.dtype = self.post.dtype
        self.num_derived = self.post.num_derived
        self._prior_arrays = self.post.space.device_arrays(self.device,
                                                           self.dtype)
        self._lo, self._hi = self._prior_arrays["lo"], self._prior_arrays["hi"]
        space = self.post.space
        classes = []
        for idx in self.proposal.block_indices:
            s = space.varying[int(idx[0])].speed
            classes.append(CLS_SLOW if s == Speed.SLOW else
                           CLS_SEMI if s == Speed.SEMISLOW else CLS_FAST)
        self.block_class = np.asarray(classes, np.int32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def _mapping(self) -> torch.Tensor:
        return self.proposal.mapping.to(self.device)

    # ---------- initialization ----------

    def init_state(self, P0) -> StagedChainState:
        P0 = torch.as_tensor(P0, dtype=self.dtype, device=self.device)
        Psafe = torch.clamp(P0, self._lo, self._hi)
        full = self.post.embed_full(Psafe)
        slow = self.post.stage_slow(full)
        semi = self.post.stage_semi(full, slow)
        mll, der = self.post.stage_fast(Psafe, slow, semi)
        prior, inb = prior_and_bounds(P0, self._prior_arrays)
        mll, der, _ = mask_posterior(mll, der, prior, inb, P0.dtype)
        # a bad start point is LOG_ZERO, not an error point (staged.py:119-122)
        mll = torch.where(mll >= LOG_ZERO * 1.5, LOG_ZERO, mll)
        return StagedChainState(P0, mll, der,
                                torch.zeros(P0.shape[0], dtype=torch.int32,
                                            device=self.device),
                                self._mapping(), slow, semi)

    def state_from_arrays(self, P, mloglike, derived, num_accept
                          ) -> StagedChainState:
        """A whole state from checkpointed arrays: the caches are rebuilt
        at P by `init_state`, then the checkpointed -logL, derived values
        and accept counts and the current mapping are put back."""
        st = self.init_state(P)
        t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=self.device)
        return st._replace(mloglike=t(mloglike, self.dtype),
                           derived=t(derived, self.dtype),
                           num_accept=t(num_accept, torch.int32),
                           mapping=self._mapping())

    # ---------- randomness ----------

    def draw_segment(self, schedule: ProposalSchedule, nchains: int,
                     mapping: torch.Tensor) -> SegmentDraws:
        """Directions, radii and acceptance draws for one segment."""
        return draw_segment(self.proposal, self.generator, schedule, nchains,
                            mapping, self.dtype)

    # ---------- one step ----------

    def step(self, state: StagedChainState, delta: torch.Tensor,
             radius: torch.Tensor, u: torch.Tensor, step_cls: int):
        trial = self.proposal.propose_step(state.P, delta, radius)
        Psafe = torch.clamp(trial, self._lo, self._hi)
        full = self.post.embed_full(Psafe)
        if step_cls == CLS_SLOW:
            slow = self.post.stage_slow(full)
            semi = self.post.stage_semi(full, slow)
        elif step_cls == CLS_SEMI:
            slow = state.slow
            semi = self.post.stage_semi(full, slow)
        else:
            slow, semi = state.slow, state.semi
        mll_t, der_t = self.post.stage_fast(Psafe, slow, semi)
        prior, inb = prior_and_bounds(trial, self._prior_arrays)
        mll_t, der_t, err = mask_posterior(mll_t, der_t, prior, inb,
                                           trial.dtype)
        acc = accept_step(mll_t, state.mloglike, u, self.temperature)
        P = torch.where(acc[:, None], trial, state.P)
        mll = torch.where(acc, mll_t, state.mloglike)
        der = torch.where(acc[:, None], der_t, state.derived)
        new = StagedChainState(
            P, mll, der, state.num_accept + acc.to(torch.int32), state.mapping,
            select_chains(acc, slow, state.slow),
            select_chains(acc, semi, state.semi))
        return new, (acc, P, mll, der, err)

    # ---------- a segment ----------

    def run_segment(self, state: StagedChainState, schedule: ProposalSchedule,
                    draws: Optional[SegmentDraws] = None
                    ) -> Tuple[StagedChainState, SegmentOutput]:
        nchains = state.P.shape[0]
        if draws is None:
            draws = self.draw_segment(schedule, nchains, state.mapping)
        step_cls = self.block_class[np.asarray(schedule.block)]
        outs = []
        for t in range(len(schedule.block)):
            state, out = self.step(state, draws.deltas[t], draws.radius[t],
                                   draws.u_accept[t], int(step_cls[t]))
            outs.append(out)
        return state, SegmentOutput(*[torch.stack(v) for v in zip(*outs)])
