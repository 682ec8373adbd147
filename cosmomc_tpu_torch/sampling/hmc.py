"""Hamiltonian Monte Carlo on a differentiable batched posterior.

Port of cosmomc_tpu/sampling/hmc.py (the sampler class pattern of the
reference's source/MCMC.f90:15-68 TSamplingAlgorithm): fixed-length
leapfrog HMC with every chain a row of a (C, n) batch, a segment of S
transitions at a time, with Nesterov dual averaging of the shared step
size and a diagonal mass matrix from the warmup variances (Hoffman &
Gelman 2014 Alg. 5 with the tree replaced by fixed-L HMC).

Gradients: the posterior maps (C, n) -> (-logL (C,), derived), and the
chains do not couple, so the gradient of the sum over chains with respect
to P is, row by row, each chain's own gradient: one backward pass a
leapfrog step for the whole batch.

Step size and inverse mass are tensors carried in the state, changed
between segments on the host. Randomness comes from the sampler's own
`torch.Generator`, drawn a segment at a time (`draw_segment`); a caller
may pass the draws in instead (`HMCDraws`).

A posterior with a slow stage (CMBPosterior) refuses gradients until its
kernels have reverse passes (ROADMAP.md queue 1 item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.io.chains import ChainWriter
from cosmomc_tpu_torch.sampling.convergence import gelman_rubin_r_device
from cosmomc_tpu_torch.sampling.metropolis import LOG_ZERO


class HMCState(NamedTuple):
    P: torch.Tensor            # (C, n)
    mloglike: torch.Tensor     # (C,) -log posterior
    grad: torch.Tensor         # (C, n) d(-logpost)/dP at P
    derived: torch.Tensor      # (C, nd)
    num_accept: torch.Tensor   # (C,) int32
    step_size: torch.Tensor    # () shared step size
    inv_mass: torch.Tensor     # (n,) diagonal inverse mass


class HMCDraws(NamedTuple):
    """Every random number one segment of S transitions uses."""
    z: torch.Tensor            # (S, C, n) standard-normal momenta
    u_jitter: torch.Tensor     # (S,) U(0, 1) step-size jitter
    u_accept: torch.Tensor     # (S, C) Exp(1) acceptance draws


class HMCSegmentOutput(NamedTuple):
    accept: torch.Tensor      # (S, C)
    P: torch.Tensor           # (S, C, n)
    mloglike: torch.Tensor    # (S, C)
    derived: torch.Tensor     # (S, C, nd)
    alpha: torch.Tensor       # (S,) mean acceptance statistic a transition


@dataclass
class HMCSampler:
    """Fixed-length leapfrog HMC over a batched posterior."""
    logpost_fn: Callable      # P (C, n) -> (mloglike (C,), derived (C, nd))
    num_leapfrog: int = 16
    num_derived: int = 0
    jitter: float = 0.2       # uniform step-size jitter fraction a step
    seed: int = 0
    #: "cuda" (the default) or "cpu"; without a card only "cpu" is accepted
    device: Any = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = kernels.entry_device(self.device, "HMCSampler")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def value_and_grad(self, P: torch.Tensor):
        """(-logL, derived, d(-logL)/dP) of every chain: the gradient of the
        sum over chains, which is each chain's own as chains do not couple."""
        with torch.enable_grad():
            q = P.detach().requires_grad_(True)
            m, d = self.logpost_fn(q)
            (g,) = torch.autograd.grad(m.sum(), q)
        return m.detach(), d.detach(), g

    def init_state(self, P0, step_size: float = 0.1,
                   inv_mass: Optional[np.ndarray] = None) -> HMCState:
        P0 = torch.as_tensor(P0, dtype=self.dtype, device=self.device)
        nchains, n = P0.shape
        mll, der, grad = self.value_and_grad(P0)
        im = (torch.ones(n, dtype=self.dtype, device=self.device)
              if inv_mass is None else
              torch.as_tensor(inv_mass, dtype=self.dtype, device=self.device))
        return HMCState(P0, mll, grad, der,
                        torch.zeros(nchains, dtype=torch.int32,
                                    device=self.device),
                        torch.as_tensor(step_size, dtype=self.dtype,
                                        device=self.device), im)

    def draw_segment(self, num_steps: int, nchains: int, n: int) -> HMCDraws:
        g, kw = self.generator, dict(dtype=self.dtype, device=self.device)
        z = torch.randn(num_steps, nchains, n, generator=g, **kw)
        u_jit = torch.rand(num_steps, generator=g, **kw)
        u_acc = torch.empty(num_steps, nchains, **kw).exponential_(generator=g)
        return HMCDraws(z, u_jit, u_acc)

    # ---------- one HMC transition (all chains) ----------

    def step(self, state: HMCState, z: torch.Tensor, u_jitter: torch.Tensor,
             u_accept: torch.Tensor) -> Tuple[HMCState, Tuple]:
        # jittered step size decorrelates trajectory-length resonances
        eps = state.step_size * (1.0 + self.jitter * (2.0 * u_jitter - 1.0))
        # momenta ~ N(0, M): p = z / sqrt(inv_mass)
        p = z / torch.sqrt(state.inv_mass)
        H0 = state.mloglike + 0.5 * torch.sum(z * z, dim=-1)
        q, g, m, d = state.P, state.grad, state.mloglike, state.derived
        for _ in range(self.num_leapfrog):
            p = p - 0.5 * eps * g
            q = q + eps * state.inv_mass * p
            m, d, g = self.value_and_grad(q)
            p = p - 0.5 * eps * g
        H1 = m + 0.5 * torch.sum(state.inv_mass * p * p, dim=-1)
        dH = H1 - H0
        # acceptance statistic for dual averaging: min(1, exp(-dH))
        alpha = torch.mean(torch.clamp(torch.exp(-torch.clamp(dH, max=50.0)),
                                       max=1.0))
        ok = (m < LOG_ZERO * 0.1) & torch.isfinite(dH)
        acc = ok & ((dH < 0) | (u_accept > dH))
        P = torch.where(acc[:, None], q, state.P)
        mll = torch.where(acc, m, state.mloglike)
        grad = torch.where(acc[:, None], g, state.grad)
        der = torch.where(acc[:, None], d, state.derived)
        new = HMCState(P, mll, grad, der,
                       state.num_accept + acc.to(torch.int32),
                       state.step_size, state.inv_mass)
        return new, (acc, P, mll, der, alpha)

    def run_segment(self, state: HMCState, num_steps: int,
                    draws: Optional[HMCDraws] = None
                    ) -> Tuple[HMCState, HMCSegmentOutput]:
        if draws is None:
            draws = self.draw_segment(num_steps, *state.P.shape)
        outs = []
        for t in range(num_steps):
            state, out = self.step(state, draws.z[t], draws.u_jitter[t],
                                   draws.u_accept[t])
            outs.append(out)
        return state, HMCSegmentOutput(*[torch.stack(v) for v in zip(*outs)])


@dataclass
class DualAveraging:
    """Nesterov dual averaging for log step size (NUTS paper Alg. 5)."""
    target: float = 0.8
    gamma: float = 0.05
    t0: float = 10.0
    kappa: float = 0.75

    def init(self, eps0: float):
        self.mu = float(np.log(10.0 * eps0))
        self.log_eps_bar = 0.0
        self.h_bar = 0.0
        self.t = 0

    def update(self, alpha: float) -> float:
        self.t += 1
        frac = 1.0 / (self.t + self.t0)
        self.h_bar = (1 - frac) * self.h_bar + frac * (self.target - alpha)
        log_eps = self.mu - np.sqrt(self.t) / self.gamma * self.h_bar
        w = self.t ** (-self.kappa)
        self.log_eps_bar = w * log_eps + (1 - w) * self.log_eps_bar
        return float(np.exp(log_eps))

    def final(self) -> float:
        return float(np.exp(self.log_eps_bar))


@dataclass
class HMCRunResult:
    steps: int
    r_minus_1: float
    accept_rate: float
    step_size: float
    means: np.ndarray
    cov: np.ndarray
    stopped_on: str


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class HMCRun:
    """Warmup (step-size dual averaging + diagonal mass estimation) then
    sampling segments with R-1 stopping: the HMC analogue of SamplingRun.
    The sampler's generator is seeded from `seed`."""

    def __init__(self, sampler: HMCSampler, nchains: int,
                 start_P: np.ndarray, seed: int = 0,
                 warmup_segments: int = 8, segment_steps: int = 32,
                 max_steps: int = 100_000, r_stop: float = 0.01,
                 step_size0: float = 0.05, target_accept: float = 0.8,
                 chain_root: Optional[str] = None, feedback: int = 0,
                 paramnames=None, space=None,
                 inv_mass0: Optional[np.ndarray] = None):
        self.sampler = sampler
        self.nchains = nchains
        self.segment_steps = segment_steps
        self.warmup_segments = warmup_segments
        self.max_steps = max_steps
        self.r_stop = r_stop
        self.feedback = feedback
        sampler.generator.manual_seed(seed)
        # initial diagonal mass: squared per-parameter scales (e.g. the
        # proposal widths); with identity mass across scales that span
        # orders of magnitude the first warmup segment rejects everything
        self.state = sampler.init_state(start_P, step_size=step_size0,
                                        inv_mass=inv_mass0)
        self.da = DualAveraging(target=target_accept)
        self.da.init(step_size0)
        self.writer = ChainWriter(chain_root, nchains) if chain_root else None
        if chain_root is not None:
            if paramnames is not None:
                paramnames.write(chain_root + ".paramnames")
            if space is not None:
                space.write_ranges(chain_root + ".ranges")
        self._stats = []
        self.steps_done = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.state.P.dtype,
                               device=self.state.P.device)

    def run(self) -> HMCRunResult:
        # ---- warmup: adapt step size each segment, mass matrix halfway ----
        warm_P = []
        for w in range(self.warmup_segments):
            self.state, out = self.sampler.run_segment(self.state,
                                                       self.segment_steps)
            alpha = float(_host(out.alpha).mean())
            eps = self.da.update(alpha)
            P = _host(out.P).astype(np.float64)
            warm_P.append(P)
            upd = dict(step_size=self._tensor(eps))
            if w == self.warmup_segments // 2 or w == self.warmup_segments - 1:
                # diagonal mass = marginal posterior variances so far
                flat = np.concatenate(warm_P[-(w // 2 + 1):]).reshape(
                    -1, P.shape[-1])
                upd["inv_mass"] = self._tensor(np.maximum(flat.var(axis=0),
                                                          1e-12))
            self.state = self.state._replace(**upd)
            if self.feedback:
                print(f"[warmup {w}] alpha={alpha:.3f} eps={eps:.2e}",
                      flush=True)
        self.state = self.state._replace(
            step_size=self._tensor(self.da.final()),
            num_accept=torch.zeros_like(self.state.num_accept))

        # ---- sampling ----
        stopped_on = "max_steps"
        r = np.inf
        while self.steps_done < self.max_steps:
            self.state, out = self.sampler.run_segment(self.state,
                                                       self.segment_steps)
            self.steps_done += self.segment_steps
            P = _host(out.P).astype(np.float64)
            self._stats.append(P)
            if self.writer is not None:
                self.writer.add_segment(_host(out.accept), _host(out.P),
                                        _host(out.mloglike), _host(out.derived))
            chains = np.concatenate(self._stats, axis=0)   # (S, C, n)
            half = chains[chains.shape[0] // 2:]           # second half only
            r = float(gelman_rubin_r_device(
                torch.as_tensor(half.swapaxes(0, 1))))
            if self.feedback:
                ar = float(self.state.num_accept.double().mean()) / self.steps_done
                print(f"[{self.steps_done} steps] R-1={r:.4f} acc={ar:.3f}",
                      flush=True)
            if r < self.r_stop:
                stopped_on = "converged"
                break
        if self.writer is not None:
            self.writer.close()
        flat = np.concatenate(self._stats, axis=0).reshape(-1, self.state.P.shape[-1])
        ar = (float(self.state.num_accept.double().mean())
              / max(self.steps_done, 1))
        return HMCRunResult(self.steps_done, r, ar,
                            float(self.state.step_size),
                            flat.mean(axis=0), np.cov(flat.T), stopped_on)
