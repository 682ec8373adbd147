"""Gelman-Rubin convergence diagnostics (port of
cosmomc_tpu/sampling/convergence.py; reference source/samples.f90:40-80
`GelmanRubinEvalues`, used by SampleCollector.f90 UpdateCovAndCheckConverge
:212-322).

Given per-chain means and covariances,

    meancov  = mean_c cov_c          (within-chain covariance)
    meanscov = cov_c(mean_c)         (between-chain covariance of the means)

whiten meanscov by the Cholesky root of meancov; "R-1" is the largest
eigenvalue. The runner uses the host float64 numpy versions between
segments; `gelman_rubin_r_device` computes the same from samples on their
own device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def chain_moments(samples: np.ndarray, weights: np.ndarray | None = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-chain weighted means/covs. samples: (nchains, nsamp, n)."""
    x = np.asarray(samples, np.float64)
    nchains, nsamp, n = x.shape
    if weights is None:
        w = np.ones((nchains, nsamp))
    else:
        w = np.asarray(weights, np.float64)
    wsum = w.sum(axis=1, keepdims=True)
    means = (w[..., None] * x).sum(axis=1) / wsum
    xc = x - means[:, None, :]
    covs = np.einsum("cs,csi,csj->cij", w, xc, xc) / wsum[..., None]
    return means, covs


def gelman_rubin_evalues(means: np.ndarray, covs: np.ndarray) -> np.ndarray:
    """Eigenvalues of the whitened between-chain covariance (ascending)."""
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    meancov = covs.mean(axis=0)
    mu = means.mean(axis=0)
    d = means - mu
    meanscov = d.T @ d / (means.shape[0] - 1)
    L = np.linalg.cholesky(meancov)
    Linv = np.linalg.inv(L)
    W = Linv @ meanscov @ Linv.T
    return np.linalg.eigvalsh(W)


def gelman_rubin_r(means: np.ndarray, covs: np.ndarray) -> float:
    """R-1 statistic: worst eigenvalue direction."""
    return float(gelman_rubin_evalues(means, covs)[-1])


def gelman_rubin_r_device(samples: torch.Tensor) -> torch.Tensor:
    """R-1 from (nchains, nsamp, n) samples (unweighted), on their device;
    NaN where the mean within-chain covariance is not positive definite
    (fewer samples a chain than parameters), as jnp.linalg.cholesky gives
    in the JAX package, without a host wait."""
    means = samples.mean(dim=1)
    xc = samples - means[:, None, :]
    covs = torch.einsum("csi,csj->cij", xc, xc) / samples.shape[1]
    meancov = covs.mean(dim=0)
    d = means - means.mean(dim=0)
    meanscov = d.T @ d / (means.shape[0] - 1)
    L, info = torch.linalg.cholesky_ex(meancov)
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    ok = info == 0
    Linv = torch.linalg.solve_triangular(torch.where(ok, L, eye), eye,
                                         upper=False)
    r = torch.linalg.eigvalsh(Linv @ meanscov @ Linv.T)[-1]
    return torch.where(ok, r, torch.full_like(r, float("nan")))
