"""Best-fit finding (action=2) and Hessian covariance estimation.

Port of cosmomc_tpu/sampling/minimize.py (reference: source/minimize.f90,
BOBYQA in whitened coordinates + low-temperature MCMC refinement rounds,
:46-64,136+; EstCovmat.f90's finite-difference Hessian):

  - L-BFGS-B (scipy's host loop) over propose-width-whitened coordinates,
    value and gradient from `torch.autograd.grad` of the batched posterior
    at one point; or Nelder-Mead without gradients;
  - an optional low-temperature refine: MetropolisSampler at temperature
    << 1 from the optimum, keeping the best visited point;
  - covariance = inverse of `torch.autograd.functional.hessian` at the best
    fit.

The posterior is batched: `logpost(P (C, n)) -> (-logL (C,), derived)`;
a point is a batch of one chain. A posterior with a slow stage
(CMBPosterior) refuses gradients until its kernels have reverse passes.

Writes the `.minimum` text layout of calclike.f90 WriteBestFitParams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.params.space import ParameterSpace


@dataclass
class BestFit:
    P: np.ndarray            # (n,) varying-parameter best fit
    mloglike: float
    n_evals: int
    converged: bool
    cov: Optional[np.ndarray] = None   # inverse-Hessian covariance


def find_best_fit(logpost: Callable, space: ParameterSpace,
                  start: Optional[np.ndarray] = None,
                  use_grad: bool = True,
                  refine_temperature: Optional[float] = 0.02,
                  refine_steps: int = 512, refine_chains: int = 64,
                  seed: int = 0, dtype=torch.float64,
                  maxiter: int = 500, device="cuda") -> BestFit:
    """Minimize -log posterior."""
    from scipy.optimize import minimize as sp_minimize

    device = kernels.entry_device(device, "find_best_fit")
    var = space.varying
    n = len(var)
    scale = np.array([max(p.propose_width, 1e-8) for p in var])
    lo = np.array([p.min for p in var]) / scale
    hi = np.array([p.max for p in var]) / scale
    x0 = (np.array([p.center for p in var]) if start is None
          else np.asarray(start, float)) / scale
    scale_t = torch.as_tensor(scale, dtype=dtype, device=device)

    def value(x) -> float:
        with torch.no_grad():
            P = torch.as_tensor(np.asarray(x, float) * scale, dtype=dtype,
                                device=device)
            return float(logpost(P[None])[0][0])

    if use_grad:
        def value_and_grad(x):
            xt = torch.as_tensor(np.asarray(x, float), dtype=dtype,
                                 device=device).requires_grad_(True)
            m = logpost((xt * scale_t)[None])[0][0]
            (g,) = torch.autograd.grad(m, xt)
            return float(m.detach()), g.double().cpu().numpy()

        # error/out-of-range points surface as a huge FLAT plateau
        # (LOG_ZERO sentinels), which breaks L-BFGS-B's zoom linesearch;
        # replace it with a SLOPED quadratic pulling back toward the best
        # finite point seen, so backtracking recovers
        track = {"x": np.array(x0), "v": np.inf}

        def obj(x):
            v, g = value_and_grad(x)
            if not np.isfinite(v) or v >= 1e28:
                d = np.asarray(x, float) - track["x"]
                return 1e12 * (1.0 + 0.5 * float(d @ d)), 1e12 * d
            if v < track["v"]:
                track["v"], track["x"] = v, np.array(x, float)
            return v, g

        res = sp_minimize(obj, x0, jac=True, method="L-BFGS-B",
                          bounds=list(zip(lo, hi)),
                          options=dict(maxiter=maxiter, ftol=1e-12,
                                       gtol=1e-9))
    else:
        res = sp_minimize(value, x0, method="Nelder-Mead",
                          options=dict(maxiter=4000, xatol=1e-8, fatol=1e-10))
    best_x = np.clip(res.x, lo, hi)
    best_v = value(best_x)
    n_evals = int(res.nfev)

    if refine_temperature:
        # low-T MCMC refinement (minimize.f90 refinement rounds): many
        # chains started at the optimum, keep the best visited point
        from cosmomc_tpu_torch.sampling.metropolis import MetropolisSampler
        from cosmomc_tpu_torch.sampling.proposal import BlockedProposal
        prop = BlockedProposal(space.speed_blocks(), slow_block_max=1,
                               propose_scale=1.0)
        prop.set_covariance(np.diag((scale * 0.05) ** 2))
        sampler = MetropolisSampler(prop, logpost, num_derived=0,
                                    temperature=refine_temperature,
                                    seed=seed, device=device, dtype=dtype)
        rng = np.random.default_rng(seed)
        P0 = best_x * scale + rng.normal(0, 0.02, (refine_chains, n)) * scale
        P0 = np.clip(P0, np.array([p.min for p in var]),
                     np.array([p.max for p in var]))
        with torch.no_grad():
            state = sampler.init_state(P0)
            seg = 64
            for _ in range(max(1, refine_steps // seg)):
                state, _ = sampler.run_segment(state,
                                               prop.make_schedule(seg, rng))
        mll = state.mloglike.double().cpu().numpy()
        i = int(np.argmin(mll))
        if mll[i] < best_v:
            best_v = float(mll[i])
            best_x = state.P[i].double().cpu().numpy() / scale
        n_evals += refine_steps * refine_chains

    return BestFit(best_x * scale, best_v, n_evals,
                   converged=bool(getattr(res, "success", True)))


def estimate_covariance(logpost: Callable, P_best: np.ndarray,
                        dtype=torch.float64, device="cuda") -> np.ndarray:
    """Parameter covariance = inverse Hessian of -log posterior at the best
    fit (supersedes EstCovmat.f90's finite-difference quadratic fit)."""
    device = kernels.entry_device(device, "estimate_covariance")
    p = torch.as_tensor(np.asarray(P_best, float), dtype=dtype, device=device)
    H = torch.autograd.functional.hessian(lambda q: logpost(q[None])[0][0], p)
    H = H.double().cpu().numpy()
    # symmetrize + guard against non-PD (flat directions get prior width)
    H = 0.5 * (H + H.T)
    w, V = np.linalg.eigh(H)
    w = np.maximum(w, 1e-12 * max(w.max(), 1e-30))
    return (V / w) @ V.T


def write_minimum_file(path: str, space: ParameterSpace, best: BestFit,
                       derived: Optional[np.ndarray] = None,
                       derived_names=None) -> None:
    """.minimum file in the reference's text layout (calclike.f90:208-257)."""
    with open(path, "w") as f:
        f.write(f" -log(Like) = {best.mloglike:18.8f}\n")
        f.write(f"  chi-sq    = {2 * best.mloglike:18.8f}\n\n")
        for i, (p, v) in enumerate(zip(space.varying, best.P)):
            f.write(f"{i + 1:5d}  {v: .7E}   {p.name:20s}  {p.label}\n")
        if derived is not None and derived_names:
            f.write("\n")
            base = len(best.P)
            for j, ((name, label), v) in enumerate(zip(derived_names, derived)):
                f.write(f"{base + j + 1:5d}  {v: .7E}   {name:20s}  {label}\n")
