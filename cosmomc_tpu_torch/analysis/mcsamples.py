"""Chain post-processing: marginal statistics, limits, convergence, PCA.

Port of cosmomc_tpu/analysis/mcsamples.py (reference: source/GetDist.f90
and python/getdist/mcsamples.py MCSamples :162, getConvergeTests :801).
Host numpy float64 on weighted samples, as there: analysis reads files and
sorts, so it stays off the card. Output files use the GetDist formats
(.margestats/.likestats/.covmat/.corr/.converge):

  - burn-in removal by fraction or row count (chains.py ignore_rows);
  - weighted means/covariance;
  - marginal limits: weighted-percentile two-tail equal-area limits with
    one-tail detection at range boundaries (the ConfidVal percentile search
    of samples.f90 + GetDist's limit-tagging convention);
  - 1D KDE marginal densities with boundary reflection;
  - Gelman-Rubin R-1 between chains and between chain halves (.converge),
    split-limit tests, correlation lengths and Raftery-Lewis;
  - PCA of the parameter correlation (GetDist.f90:478-643).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cosmomc_tpu_torch.io.chains import load_chain
from cosmomc_tpu_torch.sampling.convergence import gelman_rubin_evalues
from cosmomc_tpu_torch.utils.paramnames import ParamNames, ParamInfo


@dataclass
class ParamStats:
    name: str
    label: str
    mean: float
    sddev: float
    # (lower, upper, tag) per confidence level; tag in {"two", ">", "<", "none"}
    limits: List[Tuple[float, float, str]] = field(default_factory=list)


class MCSamples:
    """Weighted samples pooled over chains, with per-chain boundaries kept
    for convergence tests."""

    def __init__(self, samples: np.ndarray, weights: np.ndarray,
                 loglikes: np.ndarray, names: ParamNames,
                 chain_offsets: Optional[List[int]] = None,
                 ranges: Optional[Dict[str, Tuple[float, float]]] = None):
        self.samples = np.asarray(samples, np.float64)     # (N, n)
        self.weights = np.asarray(weights, np.float64)     # (N,)
        self.loglikes = np.asarray(loglikes, np.float64)   # (N,) -logL
        self.names = names
        self.chain_offsets = chain_offsets or [0, len(self.weights)]
        self.ranges = ranges or {}

    # ------------------------------------------------------------ loading

    @classmethod
    def load(cls, root: str, ignore_frac: float = 0.3,
             nchains: Optional[int] = None) -> "MCSamples":
        """Load <root>_1.txt.. with burn-in fraction removed per chain
        (getdist chains.py ignore_rows semantics) + .paramnames/.ranges."""
        chains = []
        i = 1
        while True:
            p = f"{root}_{i}.txt"
            if not os.path.isfile(p) or (nchains is not None and i > nchains):
                break
            chains.append(load_chain(p))
            i += 1
        if not chains:
            raise FileNotFoundError(f"no chains for root {root}")
        pn_path = root + ".paramnames"
        if os.path.isfile(pn_path):
            names = ParamNames.from_file(pn_path)
        else:
            names = ParamNames([ParamInfo(f"param{j+1}", f"p_{{{j+1}}}")
                                for j in range(chains[0]["samples"].shape[1])])
        ranges = {}
        if os.path.isfile(root + ".ranges"):
            with open(root + ".ranges") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 3:
                        ranges[parts[0]] = (float(parts[1]), float(parts[2]))
        ws, lls, ss, offsets = [], [], [], [0]
        for ch in chains:
            n = len(ch["weights"])
            cut = int(ignore_frac * n) if ignore_frac < 1 else int(ignore_frac)
            ws.append(ch["weights"][cut:])
            lls.append(ch["mloglike"][cut:])
            ss.append(ch["samples"][cut:])
            offsets.append(offsets[-1] + n - cut)
        return cls(np.concatenate(ss), np.concatenate(ws),
                   np.concatenate(lls), names, offsets, ranges)

    # ------------------------------------------------------------ moments

    @property
    def norm(self) -> float:
        return float(self.weights.sum())

    def means(self) -> np.ndarray:
        return (self.weights[:, None] * self.samples).sum(0) / self.norm

    def cov(self) -> np.ndarray:
        mu = self.means()
        xc = self.samples - mu
        return (self.weights[:, None] * xc).T @ xc / self.norm

    def vars(self) -> np.ndarray:
        return np.diag(self.cov())

    def corr(self) -> np.ndarray:
        c = self.cov()
        s = np.sqrt(np.maximum(np.diag(c), 1e-300))
        return c / np.outer(s, s)

    # ------------------------------------------------------------- limits

    @staticmethod
    def _weighted_quantiles_static(x: np.ndarray, w: np.ndarray,
                                   fracs) -> np.ndarray:
        """(nfrac, npar) weighted quantiles of columns of x."""
        nfrac, npar = len(fracs), x.shape[1]
        out = np.empty((nfrac, npar))
        for j in range(npar):
            order = np.argsort(x[:, j])
            cw = np.cumsum(w[order])
            for i, f in enumerate(fracs):
                idx = np.searchsorted(cw, f * cw[-1])
                out[i, j] = x[order[min(idx, len(x) - 1)], j]
        return out

    def confid_val(self, j: int, frac: float, upper: bool) -> float:
        """Weighted percentile (samples.f90 ConfidVal): value with `frac`
        of total weight above (upper) / below (lower)."""
        x = self.samples[:, j]
        order = np.argsort(x)
        cw = np.cumsum(self.weights[order])
        target = frac * cw[-1]
        if upper:
            idx = np.searchsorted(cw, cw[-1] - target)
        else:
            idx = np.searchsorted(cw, target)
        return float(x[order[min(idx, len(x) - 1)]])

    def _limits_for(self, j: int, contour: float) -> Tuple[float, float, str]:
        """Two-tail equal-area limits, downgraded to one-tail/none when the
        marginal slams into a prior boundary (GetDist limit-tag behavior)."""
        name = self.names.names[j].name if j < len(self.names.names) else ""
        tail = (1.0 - contour) / 2.0
        lo = self.confid_val(j, tail, upper=False)
        hi = self.confid_val(j, tail, upper=True)
        rng = self.ranges.get(name)
        if rng is not None:
            # GetDist-style boundary test: significant marginal density at a
            # prior edge downgrades that side to a one-tail limit
            centers, dens = self.kde_1d(j)
            peak = max(dens.max(), 1e-300)
            sig = np.sqrt(max(self.cov()[j, j], 1e-300))
            x = self.samples[:, j]
            at_lo = (x.min() - rng[0] < 0.5 * sig) and dens[0] > 0.05 * peak
            at_hi = (rng[1] - x.max() < 0.5 * sig) and dens[-1] > 0.05 * peak
            if at_lo and at_hi:
                return (rng[0], rng[1], "none")
            if at_lo:
                return (rng[0], self.confid_val(j, 1 - contour, upper=True), "<")
            if at_hi:
                return (self.confid_val(j, 1 - contour, upper=False), rng[1], ">")
        return (lo, hi, "two")

    # ------------------------------------------------------------ densities

    def kde_1d(self, j: int, n_bins: int = 256, smooth_scale: float = 1.0
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Weighted binned 1D KDE with Gaussian kernel and boundary
        reflection (getdist density machinery, simplified: Scott bandwidth
        on the weighted effective sample size)."""
        x = self.samples[:, j]
        w = self.weights
        lo, hi = x.min(), x.max()
        name = self.names.names[j].name if j < len(self.names.names) else ""
        rng = self.ranges.get(name)
        pad = 0.05 * (hi - lo + 1e-300)
        glo = max(rng[0], lo - pad) if rng else lo - pad
        ghi = min(rng[1], hi + pad) if rng else hi + pad
        grid = np.linspace(glo, ghi, n_bins)
        hist, edges = np.histogram(x, bins=n_bins, range=(glo, ghi), weights=w)
        neff = w.sum() ** 2 / (w ** 2).sum()
        sig = np.sqrt(max(self.cov()[j, j], 1e-300))
        bw = smooth_scale * 1.06 * sig * neff ** (-0.2)
        dx = edges[1] - edges[0]
        m = max(int(4 * bw / dx), 1)
        kern = np.exp(-0.5 * (np.arange(-m, m + 1) * dx / bw) ** 2)
        kern /= kern.sum()
        # reflect at hard boundaries
        padded = np.concatenate([hist[m:0:-1], hist, hist[-2:-m - 2:-1]])
        dens = np.convolve(padded, kern, mode="same")[m:-m]
        centers = 0.5 * (edges[1:] + edges[:-1])
        dens = np.maximum(dens, 0)
        if dens.max() > 0:
            dens = dens / (dens.sum() * dx)
        return centers, dens

    # ------------------------------------------------------------ converge

    def _chain_parts(self):
        parts = []
        for a, b in zip(self.chain_offsets[:-1], self.chain_offsets[1:]):
            if b - a > 1:
                parts.append((self.samples[a:b], self.weights[a:b]))
        if len(parts) < 2:
            x, w = self.samples, self.weights
            h = len(x) // 2
            parts = [(x[:h], w[:h]), (x[h:], w[h:])]
        return parts

    def converge_tests(self) -> Dict[str, float]:
        """R-1 between chains (or between halves if single chain)."""
        parts = self._chain_parts()
        means, covs = [], []
        for x, w in parts:
            norm = w.sum()
            mu = (w[:, None] * x).sum(0) / norm
            xc = x - mu
            covs.append((w[:, None] * xc).T @ xc / norm)
            means.append(mu)
        try:
            ev = gelman_rubin_evalues(np.array(means), np.array(covs))
            r = float(ev[-1])
        except np.linalg.LinAlgError:
            r = np.inf
        return {"R-1": r}

    # -- the reference's fuller converge battery (GetDist.f90:307-373,
    #    python/getdist mcsamples.getConvergeTests) ---------------------

    def split_limit_tests(self, splits=(2, 3, 4),
                          frac=(0.025, 0.975)) -> Dict[int, np.ndarray]:
        """Split-test: rms shift of the `frac` weighted quantiles across
        n consecutive splits of the full sample, in units of the overall
        sigma — per parameter. The analysis-side analog of the sampling-
        side CheckLimitsConverge."""
        x, w = self.samples, self.weights
        n, npar = x.shape
        sig = np.sqrt(np.maximum(np.diag(self.cov()), 1e-300))
        out = {}
        for ns in splits:
            edges = np.linspace(0, n, ns + 1).astype(int)
            qs = np.empty((ns, len(frac), npar))
            for i, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
                qs[i] = self._weighted_quantiles_static(x[a:b], w[a:b], frac)
            # rms over splits and requested limits, per parameter
            rms = np.sqrt(((qs - qs.mean(0)) ** 2).mean(axis=(0, 1)))
            out[ns] = rms / sig
        return out

    def correlation_lengths(self, max_lag: int = 0) -> np.ndarray:
        """Weighted integrated autocorrelation length per parameter, in
        'weight units' (the reference's corr-length block: steps between
        independent samples along the unit-weight chain)."""
        x, w = self.samples, self.weights
        n, npar = x.shape
        if max_lag <= 0:
            max_lag = min(n // 4, 500)
        mu = (w[:, None] * x).sum(0) / w.sum()
        xc = (x - mu) * np.sqrt(w)[:, None]     # weight-scaled fluctuations
        var = (xc ** 2).sum(0)
        out = np.empty(npar)
        f = np.fft.rfft(xc, n=2 * n, axis=0)
        acf = np.fft.irfft(f * np.conj(f), axis=0)[:max_lag].real
        acf /= np.maximum(acf[:1], 1e-300)
        for j in range(npar):
            tau = 1.0
            for lag in range(1, max_lag - 1, 2):
                pair = acf[lag, j] + acf[lag + 1, j]
                if pair < 0:
                    break
                tau += 2.0 * pair
            out[j] = tau * self.weights.mean()
        return out

    def raftery_lewis(self, q: float = 0.025, tol_r: float = 0.0125,
                      prob_s: float = 0.95) -> Dict[str, np.ndarray]:
        """Raftery-Lewis (1992) diagnostic per parameter on the q-quantile
        indicator chain: required thinning k, burn-in M and minimum chain
        length N for P(quantile within +-tol_r) = prob_s. Two-state
        Markov fit on the thinned indicator (GetDist.f90 Raftery block)."""
        from scipy.stats import norm as _norm
        x, w = self.samples, self.weights
        n, npar = x.shape
        # expand weights approximately by repeating high-weight rows is
        # expensive; the indicator transition rates on the weighted chain
        # are estimated with weight-carrying counts instead
        qv = self._weighted_quantiles_static(x, w, (q,))[0]
        phi = _norm.ppf(0.5 * (1.0 + prob_s))
        ks = np.ones(npar, int)
        Ms = np.zeros(npar)
        Ns = np.zeros(npar)
        for j in range(npar):
            z = (x[:, j] <= qv[j]).astype(np.float64)
            k = 1
            while k < n // 8:
                zt = z[::k]
                wt = w[::k]
                # first-order vs second-order Markov BIC test is the full
                # RL recipe; the standard shortcut: thin until the lag-1
                # autocorrelation of the indicator is small
                zc = zt - np.average(zt, weights=wt)
                denom = (wt[:-1] * zc[:-1] * zc[:-1]).sum()
                rho = 0.0 if denom <= 0 else \
                    (wt[:-1] * zc[:-1] * zc[1:]).sum() / denom
                if abs(rho) < 0.1 or len(zt) < 64:
                    break
                k += 1
            zt = z[::k]
            # two-state transition probabilities alpha: 0->1, beta: 1->0
            z0, z1 = zt[:-1], zt[1:]
            n01 = ((z0 == 0) & (z1 == 1)).sum()
            n0 = (z0 == 0).sum()
            n10 = ((z0 == 1) & (z1 == 0)).sum()
            n1 = (z0 == 1).sum()
            alpha = n01 / max(n0, 1)
            beta = n10 / max(n1, 1)
            if alpha <= 0 or beta <= 0:
                Ms[j], Ns[j] = np.nan, np.nan
                ks[j] = k
                continue
            ab = alpha + beta
            lam = abs(1.0 - ab)
            m_burn = 0.0 if lam <= 0 else \
                np.log(0.01 * ab / max(alpha, beta)) / np.log(max(lam, 1e-12))
            n_min = (ab * (2.0 - ab) / ab ** 3 * alpha * beta
                     * (phi / tol_r) ** 2)
            ks[j] = k
            Ms[j] = max(m_burn, 0.0) * k
            Ns[j] = n_min * k
        return {"thin_k": ks, "burn_M": Ms, "N_min": Ns}

    def pca(self, param_indices: Optional[Sequence[int]] = None
            ) -> Dict[str, np.ndarray]:
        """PCA of the correlation matrix (GetDist.f90:478-643 'PCA' block):
        eigenvalues/vectors of corr over the chosen parameters."""
        idx = list(param_indices) if param_indices is not None \
            else list(range(self.samples.shape[1]))
        corr = self.corr()[np.ix_(idx, idx)]
        ev, vec = np.linalg.eigh(corr)
        order = np.argsort(ev)[::-1]
        return {"evals": ev[order], "evecs": vec[:, order], "indices": np.array(idx)}

    # ------------------------------------------------------------- outputs

    def marge_stats(self, contours: Sequence[float] = (0.68, 0.95, 0.99)
                    ) -> List[ParamStats]:
        mu = self.means()
        sd = np.sqrt(np.maximum(self.vars(), 0))
        out = []
        for j, info in enumerate(self.names.names):
            if j >= self.samples.shape[1]:
                break
            st = ParamStats(info.name, info.label, float(mu[j]), float(sd[j]))
            for c in contours:
                st.limits.append(self._limits_for(j, c))
            out.append(st)
        return out

    def write_marge_stats(self, path: str,
                          contours: Sequence[float] = (0.68, 0.95, 0.99)) -> None:
        """.margestats in the GetDist text format (types.py margeStats)."""
        stats = self.marge_stats(contours)
        tag = {"two": "two tail", ">": "> one tail", "<": "< one tail",
               "none": "none"}
        with open(path, "w") as f:
            f.write("Marginalized limits: " + ", ".join(
                f"{c:g}" for c in contours) + "\n\n")
            f.write(f"{'parameter':17s} {'mean':>15s} {'sddev':>15s}")
            for i, c in enumerate(contours):
                f.write(f" {'lower' + str(i + 1):>15s} {'upper' + str(i + 1):>15s}"
                        f" {'limit' + str(i + 1):>10s}")
            f.write("\n")
            for st in stats:
                f.write(f"{st.name:17s} {st.mean:15.7E} {st.sddev:15.7E}")
                for (lo, hi, t) in st.limits:
                    f.write(f" {lo:15.7E} {hi:15.7E} {tag[t]:>10s}")
                f.write(f"   {st.label}\n")

    def write_likestats(self, path: str) -> None:
        """.likestats: best-fit sample + N-D confidence extremes
        (GetDist.f90:1761 output block)."""
        best = int(np.argmin(self.loglikes))
        # 68%/95% N-D regions: samples within the -logL thresholds
        order = np.argsort(self.loglikes)
        cw = np.cumsum(self.weights[order])
        lims = []
        for c in (0.68, 0.95):
            k = np.searchsorted(cw, c * cw[-1])
            sel = order[:max(k, 1)]
            lims.append((self.samples[sel].min(0), self.samples[sel].max(0)))
        with open(path, "w") as f:
            f.write(f"Best fit sample -log(Like) = {self.loglikes[best]:15.7f}\n\n")
            f.write("parameter  bestfit        lower1         upper1   "
                    "      lower2         upper2\n")
            for j, info in enumerate(self.names.names):
                if j >= self.samples.shape[1]:
                    break
                f.write(f"{info.name:12s} {self.samples[best, j]:14.7E}"
                        f" {lims[0][0][j]:14.7E} {lims[0][1][j]:14.7E}"
                        f" {lims[1][0][j]:14.7E} {lims[1][1][j]:14.7E}"
                        f"   {info.label}\n")

    def write_covmat(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("# " + " ".join(p.name for p in self.names.names[
                :self.samples.shape[1]]) + "\n")
            np.savetxt(f, self.cov(), fmt="%17.9E")

    def write_corr(self, path: str) -> None:
        np.savetxt(path, self.corr(), fmt="%17.9E")

    def write_converge(self, path: str) -> None:
        """Full .converge battery (GetDist.f90:307-373 output block):
        eigenvalue R-1, split-limit tests, correlation lengths, and
        Raftery-Lewis per parameter."""
        t = self.converge_tests()
        names = [p.name for p in self.names.names[:self.samples.shape[1]]]
        with open(path, "w") as f:
            f.write(f"var(mean)/mean(var) max eigenvalue R-1 = {t['R-1']:13.5f}\n\n")
            try:
                sp = self.split_limit_tests()
                f.write("Split tests: rms shift of 95% limits between "
                        "n splits, in units of sigma:\n")
                f.write("param            " + "".join(
                    f"n={n:<9d}" for n in sorted(sp)) + "\n")
                for j, nm in enumerate(names):
                    f.write(f"{nm:16s} " + "".join(
                        f"{sp[n][j]:9.4f} " for n in sorted(sp)) + "\n")
                f.write("\n")
            except Exception as e:       # degenerate tiny chains
                f.write(f"split tests unavailable: {e}\n")
            try:
                cl = self.correlation_lengths()
                f.write("Correlation lengths (weight-steps between "
                        "independent samples):\n")
                for j, nm in enumerate(names):
                    f.write(f"{nm:16s} {cl[j]:10.2f}\n")
                f.write("\n")
            except Exception as e:
                f.write(f"correlation lengths unavailable: {e}\n")
            try:
                rl = self.raftery_lewis()
                f.write("Raftery-Lewis (q=0.025, r=0.0125, s=0.95): "
                        "thin k, burn-in M, min N:\n")
                for j, nm in enumerate(names):
                    f.write(f"{nm:16s} {rl['thin_k'][j]:6d} "
                            f"{rl['burn_M'][j]:10.1f} "
                            f"{rl['N_min'][j]:12.1f}\n")
            except Exception as e:
                f.write(f"Raftery-Lewis unavailable: {e}\n")

    def write_all(self, root: str) -> Dict[str, float]:
        self.write_marge_stats(root + ".margestats")
        self.write_likestats(root + ".likestats")
        self.write_covmat(root + ".covmat")
        self.write_corr(root + ".corr")
        self.write_converge(root + ".converge")
        return self.converge_tests()
