"""Sampling run orchestrator: segments, burn-in, adaptation, convergence.

Port of cosmomc_tpu/sampling/runner.py (the reference's TSetup%DoSampling +
TMpiChainCollector, GeneralSetup.f90:115-144, SampleCollector.f90): run
the sampler a segment at a time; between segments, on the host in float64:

  - burn-in: every chain has made `burn_accepts_per_block` accepted steps
    per proposal block (the lockstep form of SampleCollector.f90:353-407);
  - post-burn samples, thinned by `stats_thin`, pooled over the second
    half; Gelman-Rubin R-1 over the chains (UpdateCovAndCheckConverge
    :212-322), optionally held by the confidence-limit spread;
  - the proposal covariance learned from the pooled samples while
    R-1 < max_r_propose_update (:311-318);
  - chain files, `.log`, `.converge_stat`, runtime control from
    `<root>.read`, and an atomic checkpoint (tmp + rename, :174-187);
  - stop when R-1 < r_stop or after max_steps.

Works with `MetropolisSampler` and `StagedMetropolisSampler` alike. The
sampler's generator is seeded from `cfg.seed` and checkpointed; the
schedules come from a host numpy generator seeded with `cfg.seed + 1`,
which is not checkpointed (as in the JAX package: a resumed run draws its
schedules afresh).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from cosmomc_tpu_torch.io.chains import ChainWriter
from cosmomc_tpu_torch.sampling.convergence import gelman_rubin_r
from cosmomc_tpu_torch.sampling.metropolis import ChainState
from cosmomc_tpu_torch.utils.ini import IniError, IniFile


@dataclass
class RunConfig:
    nchains: int = 128
    segment_steps: int = 256
    max_steps: int = 4_000_000          # reference `samples` budget
    r_stop: float = 0.01                # MPI_R_Stop
    max_r_propose_update: float = 2.0   # MPI_Max_R_ProposeUpdate
    burn_accepts_per_block: int = 50
    min_burn_segments: int = 1
    stats_thin: int = 4                 # keep every k-th step for statistics
    learn_propose: bool = True
    checkpoint_freq_segments: int = 10
    seed: int = 0
    #: chains sharded over devices: not ported yet (torch.distributed)
    num_devices: int = 0
    #: confidence-limit convergence (SampleCollector.f90:477-544
    #: CheckLimitsConverge): also require the cross-chain spread of each
    #: parameter's `limit_frac` quantiles below `limits_tol` pooled sigma;
    #: 0 = R-1 only
    limits_tol: float = 0.0
    limit_frac: float = 0.025
    #: error points (in-bounds proposals whose theory evaluated non-finite,
    #: Calculator_CAMB.f90:205-215) are counted; with stop_on_error the run
    #: aborts (settings.f90:93)
    stop_on_error: bool = False


@dataclass
class RunResult:
    steps: int
    r_minus_1: float
    burned_in_at: int
    accept_rate: float
    means: np.ndarray
    cov: np.ndarray
    wall_s: float
    stopped_on: str


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SamplingRun:
    def __init__(self, sampler, cfg: RunConfig, start_P: np.ndarray,
                 chain_root: Optional[str] = None, feedback: int = 1,
                 paramnames=None, space=None):
        if cfg.num_devices and cfg.num_devices > 1:
            raise NotImplementedError(
                "SamplingRun: chains over several devices are not ported yet "
                "(ROADMAP queue 1, step 19)")
        self.sampler = sampler
        self.cfg = cfg
        self.feedback = feedback
        self.rng = np.random.default_rng(cfg.seed + 1)
        sampler.generator.manual_seed(cfg.seed)
        self.state = sampler.init_state(start_P)
        self.writer = ChainWriter(chain_root, cfg.nchains) if chain_root else None
        self.chain_root = chain_root
        # GetDist sidecars (driver.F90:209-216)
        if chain_root is not None:
            if paramnames is not None:
                paramnames.write(chain_root + ".paramnames")
            if space is not None:
                space.write_ranges(chain_root + ".ranges")
        self.nblocks = len(sampler.proposal.block_sizes)
        self._stats: List[np.ndarray] = []   # post-burn thinned samples (S', C, n)
        self.steps_done = 0
        self.burned_in_at = -1
        self.r_current = np.inf
        self.limits_spread = None
        self._read_mtime = 0.0               # runtime-control file freshness
        # slow/semi/fast step counters (CalcLike_Cosmology.f90:96-102)
        self.class_steps = np.zeros(3, np.int64)
        self.num_error_points = 0
        self._log = (open(chain_root + ".log", "a", buffering=1)
                     if chain_root else None)

    def _say(self, msg: str) -> None:
        if self._log is not None:
            self._log.write(msg + "\n")
        if self.feedback > 0:
            print(msg, flush=True)

    # ---------- main loop ----------

    def run(self) -> RunResult:
        cfg = self.cfg
        t0 = time.time()
        stopped_on = "max_steps"
        seg_i = 0
        while self.steps_done < cfg.max_steps:
            sched = self.sampler.proposal.make_schedule(cfg.segment_steps, self.rng)
            if hasattr(self.sampler, "block_class"):
                cls = self.sampler.block_class[np.asarray(sched.block)]
                np.add.at(self.class_steps, cls, 1)
            else:
                self.class_steps[0] += cfg.segment_steps
            self.state, out = self.sampler.run_segment(self.state, sched)
            acc, P = _host(out.accept), _host(out.P)
            mll, der = _host(out.mloglike), _host(out.derived)
            n_err = int(out.error.sum())
            if n_err:
                self.num_error_points += n_err
                msg = (f"ERROR POINTS: {n_err} in-bounds proposals with "
                       f"non-finite theory this segment "
                       f"({self.num_error_points} total)")
                self._say(msg)
                if cfg.stop_on_error:
                    raise RuntimeError(
                        msg + " - aborting (stop_on_error=T, reference "
                        "settings.f90:93)")
            self.steps_done += cfg.segment_steps
            seg_i += 1

            if self._check_burn_in(seg_i):
                self._stats.append(P[::cfg.stats_thin].astype(np.float64))
                if self.writer is not None:
                    self.writer.add_segment(acc, P, mll, der)
                r = self._update_convergence_and_proposal()
                self._write_converge_stat(done=False)
                if seg_i % 4 == 0:
                    cs = self.class_steps
                    line = (f"[{self.steps_done:>8d} steps] R-1 = {r:.4f}  "
                            f"acc = {self._accept_rate():.3f}  "
                            f"slow/semi/fast = {cs[0]}/{cs[1]}/{cs[2]}"
                            + (f"  error_points = {self.num_error_points}"
                               if self.num_error_points else ""))
                    # lockstep chains share one log (MCMC.f90:299-304)
                    self._say(line)
                if r < cfg.r_stop:
                    stopped_on = "converged"
                    break
            if self.writer is not None and seg_i % cfg.checkpoint_freq_segments == 0:
                self.checkpoint()
            if self._check_runtime_control():
                stopped_on = "exit_requested"
                break

        if self.writer is not None:
            self.writer.close()
            self.checkpoint()
        if self._log is not None:
            self._log.close()
            self._log = None
        self._write_converge_stat(done=stopped_on == "converged")
        means, cov = self._pooled_moments()
        return RunResult(self.steps_done, self.r_current, self.burned_in_at,
                         self._accept_rate(), means, cov, time.time() - t0,
                         stopped_on)

    def _accept_rate(self) -> float:
        return (float(self.state.num_accept.double().mean())
                / max(self.steps_done, 1))

    # ---------- runtime control ----------

    def _check_runtime_control(self) -> bool:
        """Poll `<root>.read` between segments (CheckParamChange,
        settings.f90:290-313): a small ini beside the chains can change
        feedback or ask for a clean exit. True if an exit was asked for."""
        if self.chain_root is None:
            return False
        path = self.chain_root + ".read"
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return False
        if mtime <= self._read_mtime:
            return False
        self._read_mtime = mtime
        try:
            ini = IniFile(path)
        except (OSError, IniError, ValueError):
            return False
        fb = ini.int("feedback")
        if fb is not None:
            self.feedback = fb
            print(f"runtime control: feedback -> {fb}", flush=True)
        if ini.bool("exit", False):
            print("runtime control: exit requested", flush=True)
            return True
        return False

    # ---------- burn-in ----------

    def _check_burn_in(self, seg_i: int) -> bool:
        """Burn-in ends when the slowest chain has its accepts (so one stuck
        chain holds every chain's writing back, as in the JAX package)."""
        if self.burned_in_at >= 0:
            return True
        if seg_i < self.cfg.min_burn_segments:
            return False
        need = self.cfg.burn_accepts_per_block * self.nblocks
        if int(self.state.num_accept.min()) >= need:
            self.burned_in_at = self.steps_done
            if self.feedback > 0:
                print(f"burn-in done at step {self.steps_done}", flush=True)
            return True
        return False

    # ---------- convergence + adaptation ----------

    def _pooled_moments(self):
        if not self._stats:
            P = _host(self.state.P).astype(np.float64)
            return P.mean(axis=0), np.cov(P.T) if P.shape[1] > 1 else np.var(P.T)[None, None]
        x = np.concatenate(self._stats, axis=0)          # (S', C, n)
        half = x[x.shape[0] // 2:]                       # second half of post-burn
        flat = half.reshape(-1, half.shape[-1])
        mu = flat.mean(axis=0)
        xc = flat - mu
        return mu, xc.T @ xc / flat.shape[0]

    def _update_convergence_and_proposal(self) -> float:
        x = np.concatenate(self._stats, axis=0)          # (S', C, n)
        half = x[x.shape[0] // 2:]
        means = half.mean(axis=0)                        # (C, n)
        xc = half - means[None, :, :]
        covs = np.einsum("sci,scj->cij", xc, xc) / half.shape[0]
        try:
            r = gelman_rubin_r(means, covs)
        except np.linalg.LinAlgError:
            r = np.inf
        self.r_current = r
        # confidence-limit convergence (CheckLimitsConverge): the worst
        # cross-chain rms of the limit_frac quantiles, in pooled sigma
        self.limits_spread = None
        if self.cfg.limits_tol > 0:
            fr = self.cfg.limit_frac
            q = np.quantile(half, [fr, 1.0 - fr], axis=0)   # (2, C, n)
            sig = half.reshape(-1, half.shape[-1]).std(axis=0) + 1e-30
            self.limits_spread = float((q.std(axis=1) / sig).max())
            if self.limits_spread > self.cfg.limits_tol:
                # hold convergence until the limits settle too
                self.r_current = max(self.r_current,
                                     self.cfg.r_stop + self.limits_spread)
                r = self.r_current
        if (self.cfg.learn_propose and r < self.cfg.max_r_propose_update
                and half.shape[0] * half.shape[1] > 10 * means.shape[1]):
            flat = half.reshape(-1, half.shape[-1])
            mu = flat.mean(axis=0)
            cov = (flat - mu).T @ (flat - mu) / flat.shape[0]
            try:
                self.sampler.proposal.set_covariance(cov)
                # the next segment proposes with the new mapping
                self.state = self.state._replace(
                    mapping=self.sampler.proposal.mapping.to(
                        self.state.mapping.device))
            except np.linalg.LinAlgError:
                pass
        # cap the kept statistics (the reference thins above ~500k)
        if x.shape[0] * x.shape[1] > 2_000_000:
            self._stats = [x[::2]]
        return r

    def _write_converge_stat(self, done: bool) -> None:
        """`<root>.converge_stat`: R-1, and "Done" once converged (the file
        the reference's grid layer polls, SampleCollector.f90:461-475)."""
        if self.chain_root is None:
            return
        with open(self.chain_root + ".converge_stat", "w") as f:
            f.write(f"{self.r_current:17.5f}\n")
            if done:
                f.write("Done\n")
            if self.limits_spread is not None:
                f.write(f"limits spread/sigma: {self.limits_spread:.5f}\n")

    # ---------- checkpoint / resume ----------

    def checkpoint(self) -> None:
        """`<root>.chk.npz`, written to a temporary file and renamed: the
        state's arrays, the sampler generator's state (uint8), the step
        counts and the proposal covariance."""
        if self.chain_root is None:
            return
        path = self.chain_root + ".chk.npz"
        tmp = path + ".tmp.npz"
        st = self.state
        np.savez(
            tmp,
            P=_host(st.P), mloglike=_host(st.mloglike),
            derived=_host(st.derived), num_accept=_host(st.num_accept),
            generator=self.sampler.generator.get_state().numpy(),
            steps_done=self.steps_done, burned_in_at=self.burned_in_at,
            propose_cov=self.sampler.proposal.covariance,
        )
        os.replace(tmp, path)

    def resume(self) -> bool:
        path = (self.chain_root or "") + ".chk.npz"
        if not self.chain_root or not os.path.isfile(path):
            return False
        z = np.load(path)
        self.sampler.proposal.set_covariance(z["propose_cov"])
        if hasattr(self.sampler, "state_from_arrays"):
            # the staged sampler rebuilds its per-chain theory caches too
            self.state = self.sampler.state_from_arrays(
                z["P"], z["mloglike"], z["derived"], z["num_accept"])
        else:
            dev = self.sampler.device
            t = lambda k: torch.as_tensor(z[k], device=dev)
            self.state = ChainState(t("P"), t("mloglike"), t("derived"),
                                    t("num_accept"),
                                    self.sampler.proposal.mapping.to(dev))
        self.sampler.generator.set_state(torch.from_numpy(z["generator"].copy()))
        self.steps_done = int(z["steps_done"])
        self.burned_in_at = int(z["burned_in_at"])
        return True
