#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 1 builds the seven hand-written kernels and their instantiations
(csrc/, nvcc, sm_90a), one nvcc process per source, all started together.
Phase 2 runs in a process of its own on the card (`--phase2`), beside
phases 3-16 of the main one, which prints its log after phase 16: the
plain versions it holds the kernels to are Python loops bound by their
launches on the host. It holds each kernel against its plain PyTorch version at the main
paths' shapes, in float32 and float64, times both, and computes each
kernel's bound from shape-based counts (OPS): the larger of its operations
over the card's peak rate for their type and its bytes over the memory
rate. K4, K1 and K5 are also timed on one chain or lane: what one
dependency chain costs, however many run beside it.
Phase 3 runs the flagship path at full width in float32 (table LOS engine,
halofit lensing): C_l at the best fit, a plik_lite fiducial written from
them, then CMBPosterior (plik_lite + tau prior, synthetic BBN table) under
StagedMetropolisSampler: init on 8 chains and one 16-step segment with one
slow step.
Phase 4 runs the LCDM+r path the same way (compute_tensors=True, r
semi-slow, recurrence LOS engine, halofit lensing), its fiducial written at
the best fit with r = 0.1, and checks the tensor-only spectrum there.
Phase 5 runs the flagship at phase 3's width under SamplingRun, the run
loop users call: plik_lite + a synthetic DR12-shaped BAO set written from
the port's theory at the best fit + the tau prior, 8 chains, four 16-step
segments from the runner's own schedules, chain files and checkpoints;
then a second run resumes from the checkpoint and must restore the state,
the caches and the generator bit for bit and take the same next segment.
Phase 6 samples the background configuration (BAO + SN + H0 on synthetic
DR12, 6dF and 1048-SN Pantheon-format sets) with MetropolisSampler under
SamplingRun, 256 chains, until R-1 < 0.01.
Phase 2 also holds K1 on the matter grid (216 k to 8/Mpc, one chain) to
its plain version and float32 to float64 at the 6144 steps of the matter
transfers (sigma8, f sigma8 within 0.5%).
Phase 7 runs the flagship with matter power (K1 twice a slow step):
sigma8 and f sigma8 at the best fit against CAMB, and one staged segment
with plik_lite + a DR12 set with f_sigma8 rows + the tau prior.
Phase 8 runs the astro LSS-only configuration (use_cmb=False: K4 and K1
only) with synthetic LRG DR4-format, WiggleZ-format and DR12 f_sigma8 sets
under SamplingRun, 32 chains, then resumes it bit for bit.
Phase 2 also holds K1's extended instantiations, the massive-neutrino
hierarchy and the dark-energy fluid (with a CDM-isocurvature chain), to
the plain version in float64, on the source grid and (massive nu) on the
matter grid; the main process does so after phase 12, the plain versions
computed by two more processes on the card beside phases 3-12
(`--plain-card`, `--plain-card-de`).
Phase 9 runs Planck 2018's base_mnu on the flagship (mnu free, matter
power; K1's massive-neutrino instantiation twice a slow step): float32
against float64, plik_lite + a DR12 set with f_sigma8 rows + the tau prior,
one staged segment, and sigma8 at mnu = 0.07 eV against CAMB.
Phase 10 runs base_w_wa the same way (w and wa free; the DE-fluid
instantiation), then the CDM-isocurvature response at four alpha1 values
in float64: C_l quadratic in the admixture amplitude.
Phase 11 runs the SPT configuration on the flagship: SPTpol TE/EE and BB
and an SPT-SZ-shaped CMBLike2 TT set (written from the port's float64
theory at the best fit) raise lmax to 8001, the Boltzmann C_l stop at
2508 and a high-l template written from phase 3's float64 lensed
spectrum fills above. K2a and K3 must run at the flagship's shapes, the
spliced C_l equal the scaled template, -logL at the best fit its
constant (the SPTpol sets' half ln det Cov plus the tau prior); then a
few staged segments, and BK-Planck and CMBLikes HL and fullsky-exact on
the cached theory, float32 against float64.
Phase 12 runs the LSS-only configuration with a BBN prior (the astro
parameterization, K4 and K1 only): DES 1YR-shaped 3x2pt, Planck
2015-shaped SZ cluster counts, D/H and Yp abundances on a written BBN
grid and DR12 BAO with f_sigma8, float32 theory and float64 likelihoods,
32 chains, two staged segments; then the action=4 per-likelihood table on
phase 3's flagship posterior.
Phase 2 also holds the reverse kernels of K4 and K1 (the gradient path's)
to autograd of their plain versions, computed on the host CPU by a
process that phase 2's starts (`--plain-ref`).
Phase 13 runs the ini driver: the CLI, actions 0, 1, 2 and 4, HMC and
the grid CLI.
Phase 14 runs the gradient path on phase 12's configuration: the float64
gradient against central differences and against the host CPU's plain
gradient (`--cpu-grad`, started before phase 3), HMC through the CLI
(started before phase 13) and action 2.
Phase 2 also holds the reverse kernels of K2a and K3 (los_bwd,
lensing_bwd) at the flagship's shapes to autograd of their plain versions
on the card, and K1's (boltzmann_bwd) on the CMB grid at 8191 steps to its
plain version on the host CPU (`--plain-ref-cmb`, one chain).
Phase 15 runs the flagship's gradient at full width in float64 through
K4, K1, K2a, K3 and their reverse kernels: against central differences
without halofit, against the host CPU's plain gradient at
test_torch_slice.py's small config (`--cpu-grad-cmb`), HMC through the
CLI on the flagship ini (started after phase 5) and action 2 on it.
Phase 2 also holds the reverse kernels of K1's extended instantiations
(boltzmann_nu_bwd, boltzmann_de_bwd, boltzmann_nu_de_bwd) to autograd of
their plain versions on the host CPU at a reduced shape that crosses every
switch (`--plain-ref-nu|de|nu-de`, started before phase 3), in the main
process after phase 12, and times them at the main paths' shapes.
Phase 16 runs the gradients of base_mnu and of base_w_wa with alpha1 free
at full width in float64 (K1's extended instantiations with their reverse
kernels, on the source and the matter grids): against central
differences, against the host CPU's plain gradient at a small config
(`--cpu-grad-ext`, a process a configuration, started before phase 3), HMC
through the CLI on the base_mnu ini (started before phase 13) and action
2 on the base_w_wa ini (`--ext-min`, a process on the card beside phases
14 and 15). Phase 13's two CLI processes of action 4 start after phase
12, beside the main process's part of phase 2.
Phase 2 also holds the reverse kernels of the tensor modes (tensors_bwd,
K5; tensor_los_bwd, K6) in phase 2's process: K5's to autograd of its
plain version on the host CPU at a reduced shape that crosses every switch
(`--plain-ref-tensors`), K6's to autograd of its plain version on the card
at the main path's shape; both timed at the main path's shapes.
Phase 17 runs LCDM+r's gradient (r free, the table line of sight) at full
width in float64 through K4, K1, K2a, K3, K5, K6 and their reverse
kernels: against central differences without halofit, against the host
CPU's plain gradient at test_torch_slice.py's small config
(`--cpu-grad-lcdm-r`, started before phase 3), HMC through the CLI's
entry on an LCDM+r ini (`--lcdm-r-hmc`, started after phase 13), and the
refusal of the recurrence line of sight (K2b).

It fails (non-zero exit, no result line) when there is no CUDA device,
when the port is not importable, when a kernel does not build, launch or
agree, or when a phase's output is wrong. The last line of standard output
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import signal
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
               tau=0.05430138, logA=3.0447260, ns=0.9658923, r=0.1)
NCHAINS = 8
SEG_STEPS = 16
K1_CMP_STEPS = 2048      # K1 and K5 are held to their plain versions here
#: phase 6 (the background configuration): chains (the JAX recipe's
#: >= 256), SNe (Pantheon's count), segment length, and a step budget that
#: keeps the phase near a minute on an H100 (it converged after 2816 steps,
#: in 28-32 s, on an NVIDIA H100 80GB HBM3 at 700 W)
BG_NCHAINS, BG_NSN, BG_SEG_STEPS, BG_MAX_STEPS = 256, 1048, 64, 150 * 64
#: phase 8 (the astro configuration): chains and 16-step segments
ASTRO_NCHAINS, ASTRO_SEGMENTS = 32, 4
MUK2 = 2.7255e6 ** 2
F32, F64 = torch.float32, torch.float64
#: CAMB at the Planck 2018 best fit, with tests/test_matterpower.py's 2.5%
#: tolerance (:22-26, :40-51): sigma8(0), and f sigma8 at the DR12 redshifts
CAMB_SIGMA8, CAMB_TOL = 0.8119545, 0.025
CAMB_FSIGMA8 = {0.38: 0.4779339, 0.51: 0.4760216, 0.61: 0.4706936}
#: float32 sigma8(z) and f sigma8(z) against float64, at the full 6144 steps
SIGMA8_F32_TOL = 5e-3
#: CMBPosterior's default matter-power redshifts
Z_PK = (0.0, 0.2, 0.38, 0.51, 0.61, 1.0, 2.0)
#: phases 9 and 10: the extension parameters as users free them (ini
#: overrides): mnu as the repo's grid (cosmomc_tpu/grid/gridconfig.py:16),
#: w as tests/test_grid.py:25, wa over Planck 2018's w0-wa prior range,
#: alpha1 as the reference (cosmomc_tpu/params/parameterizations.py:177)
EXT_FREE = {"mnu": {"mnu": "0.06 0 5 0.1 0.03"},
            "w0wa": {"w": "-1 -3 1 0.1 0.05", "wa": "0 -3 2 0.1 0.05"}}
ALPHA1_FREE = "0 -0.3 0.3 0.01 0.01"
#: each path's point beside BESTFIT, off the LCDM values (w0, wa crosses
#: w = -1)
EXT_POINT = {"mnu": {"mnu": 0.1}, "w0wa": {"w": -0.9, "wa": -0.3}}
#: CAMB at mnu = 0.07 eV (tests/test_extended_oracle.py:97-117, H0 67.5,
#: ombh2 0.022, omch2 0.122, A_s 2e-9, n_s 0.965, tau 0.06): sigma8(z)
CAMB_SIGMA8_MNU, CAMB_MNU_TOL = {0.0: 0.80044, 3.1: 0.24686}, 0.015
#: the CDM-isocurvature amplitude b of phase 10 (C_l at 0, +-b, 2b) and
#: tests/test_isocurvature.py's tolerance on the quadratic response
ISO_B, ISO_RTOL, ISO_ATOL = 0.2, 5e-4, 1e-6
#: K1's extended instantiations are held to the plain float64 version
#: alone; their float32 output within this share of each plane's maximum
K1_VARIANT_F32_FLOOR = 1e-3
#: step counts tried in turn for holding K1 to its plain version on the
#: matter grid: the first at which every lane of the float32 and float64
#: kernels stays finite and bounded. An unstable RK4 lane grows without
#: bound (the plain version in float64 on the CPU, 2048 steps: the k =
#: 8/Mpc lane reaches |delta_m| ~ 3e17, where 3072 steps keep every lane
#: below ~1e5); `MATTER_BOUNDED` bounds |delta_m| before the curvature
#: normalisation
MATTER_CMP_STEPS = (K1_CMP_STEPS, 3072, 4096, 6144)
MATTER_BOUNDED = 1e8

#: phase 11 (the SPT configuration): the Boltzmann C_l stop at the
#: flagship's lmax and the template fills above, to the lmax the SPTpol
#: TE/EE set asks for (8000 + 1 for its l-derivative); the segments the
#: staged sampler runs; the bound on float32-theory minus float64-theory
#: -logL (each set written at the float64 theory without scatter, so both
#: are near their constant) and on the spliced C_l against norm x template
#: (float32 rounding)
SPT_LMAX_COMPUTED, SPT_LMAX, SPT_SEGMENTS = 2508, 8001, 3
SPT_F32_TOL, SPLICE_RTOL = 1.0, 1e-6
#: K2a's (sampled l, fine k) and K3's lensed width on the flagship
FLAGSHIP_K2A_SHAPE, FLAGSHIP_LENSED_L = (109, 4521), 2507

#: phase 12 (the LSS-only configuration with a BBN prior): chains,
#: segments of SEG_STEPS with one slow step each, the bound on
#: float32-theory minus float64-theory -logL of each likelihood, and the
#: float64 checks at the centres (WL's chi^2/2 at the theory its set was
#: written from; the abundances and SZ against their sums by hand)
LSS_NCHAINS, LSS_SEGMENTS, LSS_F32_TOL = 32, 2, 1.0
LSS_WL_ZERO, LSS_HAND_RTOL = 1e-6, 1e-9

#: phase 13 (the ini driver): the flagship's action 0 (NCHAINS chains,
#: SEG_STEPS-step segments) runs DRIVER_SEGMENTS segments; the HMC run on
#: the background ini (chains, warmup segments, segment steps, sampled
#: steps, leapfrog steps); the CLI's -logL against the posterior built by
#: hand; and the grid's job (chains, steps: enough for RunConfig's 50
#: accepts a block before rows are written) with its HST importance rerun
DRIVER_SEGMENTS = 4
DRIVER_HMC = dict(num_chains=64, hmc_warmup_segments=4, segment_steps=8,
                  samples=64, hmc_leapfrog_steps=8)
DRIVER_MLL_RTOL = 1e-9
DRIVER_GRID = dict(num_chains=64, segment_steps=64, samples=512)

#: the reverse kernels (phase 2): K1's checkpoint chunks (JAX's HMC
#: default, driver.py:205), float32 within this share of each output's
#: largest magnitude of the float64 plain gradient (tensors_bwd and
#: tensor_los_bwd read 7.1e-7 and 4.9e-6 on an H100, 14x and 10x below
#: their floors); the host threads of the
#: plain references and of phase 14's CPU gradient, in processes of their
#: own beside the card's phases (few: the card's phases are host-bound
#: too), JOB_TIMEOUT seconds at most
GRAD_CHUNKS = 64
GRAD_F32_TOL = {"recfast_bwd": 1e-4, "boltzmann_bwd": 1e-3, "los_bwd": 1e-3,
                "lensing_bwd": 1e-5, "boltzmann_nu_bwd": 1e-3,
                "boltzmann_de_bwd": 1e-3, "boltzmann_nu_de_bwd": 1e-3,
                "tensors_bwd": 1e-5, "tensor_los_bwd": 5e-5}
JOB_THREADS = {"--plain-ref": 2, "--cpu-grad": 1, "--plain-ref-cmb": 1,
               "--cpu-grad-cmb": 1, "--plain-card": 1, "--plain-card-de": 1,
               "--plain-ref-nu": 1, "--plain-ref-de": 1, "--plain-ref-nu-de": 1,
               "--cpu-grad-ext": 1, "--ext-min": 1, "--phase2": 1,
               "--plain-ref-tensors": 1, "--cpu-grad-lcdm-r": 1,
               "--lcdm-r-hmc": 1}
JOB_TIMEOUT = 900
#: chains of the CMB-grid K1 reference on the host CPU (8191 plain steps
#: under autograd there take minutes a chain)
CMB_REF_CHAINS = 1
#: phase 14's comparison with the CPU's plain gradient runs both on
#: test_torch_lss_astro.py's reduced matter grid (36 k to 2/Mpc, 2048
#: steps; the full grid's 6143 plain steps under autograd take ~950 s on
#: the host, where phase 14's other checks hold the full width)
CPU_GRAD_MATTER = dict(kmax=2.0, nk_log_lo=8, nk_lin=16, nk_log_hi=12)
CPU_GRAD_STEPS = 2048
#: phase 14 (the gradient path): the finite-difference step (a share of
#: each parameter's proposal width) and the tolerance of the gradient
#: against those differences and against the CPU's plain gradient (both
#: relative to the largest component); the HMC run through the CLI
#: (chains, warmup segments, segment steps, sampled steps, leapfrog steps)
#: and its acceptance band; the minimizer's low-temperature refine steps
#: and L-BFGS-B iterations (action 2 from the centre, cut to ~20 s)
GRAD_FD_STEP, GRAD_FD_TOL, GRAD_CPU_TOL = 1e-6, 1e-5, 1e-8
GRAD_HMC = dict(num_chains=8, hmc_warmup_segments=2, segment_steps=4,
                samples=8, hmc_leapfrog_steps=4)
GRAD_HMC_ACCEPT = (0.05, 1.0)
GRAD_MIN_REFINE, GRAD_MIN_ITER = 16, 10
#: phase 15 (the flagship's gradient): test_torch_slice.py's small config,
#: at which the card's gradient is held to the host CPU's plain one
#: (`--cpu-grad-cmb`, started before phase 3); the HMC run through the CLI
#: (started after phase 5; a step of 0.01 proposal widths to start from:
#: the synthetic plik_lite set puts the posterior's width at ~0.07 of them,
#: and one short warmup segment does not adapt far from the start)
FLAG_SMALL = dict(kmax=0.1, source_nk=(24, 48), n_step_boltzmann=2048)
FLAG_HMC = dict(num_chains=8, hmc_warmup_segments=1, segment_steps=2,
                samples=4, hmc_leapfrog_steps=4, hmc_step_size=0.01)
#: phase 15's central differences also at these steps (logged)
FLAG_FD_STEPS = (3e-6, 1e-5)
#: K1's extended reverse kernels (phase 2): their instantiation and switches,
#: and the reduced shape at which they are held to autograd of the plain
#: version on the host CPU (`--plain-ref-nu|de|nu-de`, started before phase 3):
#: VariantInputs' first and last chains (mnu 0.06 and 0.3 eV, w0 -0.8 and
#: -1.2, wa -0.4 and 0.3; isocurvature 0.2 on the first) x every
#: EXT_REF_K_STRIDE-th k of the source grid (31 of 248, to 0.5/Mpc) x
#: K1_CMP_STEPS steps, a seeded cotangent dense on all 7 planes: lanes and
#: steps that cross tight coupling, RSA (the DE fluid's freeze), nu_rel_rsa
#: by (am < 2) and by k dt_loc > 0.9, and the ICs' release
EXT_BWD = {"boltzmann_nu_bwd": ("boltzmann_nu", (True, False)),
           "boltzmann_de_bwd": ("boltzmann_de", (False, True)),
           "boltzmann_nu_de_bwd": ("boltzmann_nu_de", (True, True))}
EXT_REF_CHAINS, EXT_REF_K_STRIDE = (0, NCHAINS - 1), 8
#: the host process that computes each one's plain reference
PLAIN_REF_EXT_PARTS = {"--plain-ref-nu": "boltzmann_nu_bwd",
                       "--plain-ref-de": "boltzmann_de_bwd",
                       "--plain-ref-nu-de": "boltzmann_nu_de_bwd"}
#: phase 16 (base_mnu and base_w_wa with alpha1 free): the gradient's
#: comparison with the host CPU's plain one (`--cpu-grad-ext`, started
#: before phase 3) at FLAG_SMALL with the reduced matter grid of phase 14,
#: one point a configuration; the HMC run through the CLI on the base_mnu
#: ini (started before phase 13)
EXT_GRAD = {"mnu": dict(alpha1=False), "w0wa": dict(alpha1=True)}
EXT_HMC = dict(num_chains=8, hmc_warmup_segments=1, segment_steps=2,
               samples=4, hmc_leapfrog_steps=2, hmc_step_size=0.01)
#: phase 16's central differences, at each point the closer of these
#: steps (proposal widths) to the gradient: -logL is piecewise smooth, so
#: the differences carry its float64 rounding at the smaller step and a
#: kink within the larger one where one lies there (base_mnu's offset
#: point along omch2: 2.46e-5 of the largest component at 1e-6 widths,
#: 7.8e-6 at 3e-7; scripts/ext_fd_steps.py)
EXT_FD_STEPS = (3e-7, GRAD_FD_STEP)

#: phase 17 (LCDM+r's gradient): the ini keys that free r (test.ini's
#: range, as users set it); central differences at each point at the closer
#: of LCDMR_FD_STEPS proposal widths to the gradient (mapped on the CPU at
#: test_torch_slice.py's small config by scripts/lcdm_r_fd_steps.py); the
#: HMC run through the CLI on the LCDM+r ini (`--lcdm-r-hmc`, started after
#: phase 13)
LCDMR_FREE = {"compute_tensors": "T", "param[r]": "0.1 0 2 0.04 0.04"}
LCDMR_FD_STEPS = (3e-7, GRAD_FD_STEP)
LCDMR_HMC = dict(num_chains=8, hmc_warmup_segments=1, segment_steps=2,
                 samples=4, hmc_leapfrog_steps=2, hmc_step_size=0.01)

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "recfast": ("cosmomc_tpu_torch/csrc/recfast.cu",
                "cosmomc_tpu/models/recfast.py:279"),
    "boltzmann": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                  "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_nu": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                     "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_de": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                     "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_nu_de": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                        "cosmomc_tpu/models/perturbations.py:928"),
    "los": ("cosmomc_tpu_torch/csrc/cls.cu", "cosmomc_tpu/models/cls.py:285"),
    "lensing": ("cosmomc_tpu_torch/csrc/lensing.cu",
                "cosmomc_tpu/models/lensing.py:136"),
    "los_rec": ("cosmomc_tpu_torch/csrc/los_recurrence.cu",
                "cosmomc_tpu/models/cls.py:473"),
    "tensors": ("cosmomc_tpu_torch/csrc/tensors.cu",
                "cosmomc_tpu/models/tensors.py:254"),
    "tensor_los": ("cosmomc_tpu_torch/csrc/tensor_los.cu",
                   "cosmomc_tpu/models/tensors.py:352"),
    # the reverse passes: jax.grad over the same scans
    "recfast_bwd": ("cosmomc_tpu_torch/csrc/recfast.cu",
                    "cosmomc_tpu/models/recfast.py:279"),
    "boltzmann_bwd": ("cosmomc_tpu_torch/csrc/boltzmann_bwd.cu",
                      "cosmomc_tpu/models/perturbations.py:928"),
    "los_bwd": ("cosmomc_tpu_torch/csrc/cls.cu", "cosmomc_tpu/models/cls.py:285"),
    "lensing_bwd": ("cosmomc_tpu_torch/csrc/lensing.cu",
                    "cosmomc_tpu/models/lensing.py:136"),
    "boltzmann_nu_bwd": ("cosmomc_tpu_torch/csrc/boltzmann_bwd.cu",
                         "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_de_bwd": ("cosmomc_tpu_torch/csrc/boltzmann_bwd.cu",
                         "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_nu_de_bwd": ("cosmomc_tpu_torch/csrc/boltzmann_bwd.cu",
                            "cosmomc_tpu/models/perturbations.py:928"),
    "tensors_bwd": ("cosmomc_tpu_torch/csrc/tensors.cu",
                    "cosmomc_tpu/models/tensors.py:254"),
    "tensor_los_bwd": ("cosmomc_tpu_torch/csrc/tensor_los.cu",
                       "cosmomc_tpu/models/tensors.py:352"),
}
#: the kernels each main path must launch (phase 5 "runner" is the
#: flagship under SamplingRun; phase 6 "background" launches none; phase 7
#: "flagship_mp" is the flagship with matter power, K1 twice a slow step;
#: phase 8 "astro" the LSS-only configuration; phases 9 "mnu" and 10
#: "w0wa" K1's extended instantiations, twice a slow step; phase 11 "spt"
#: the flagship's kernels at the flagship's shapes under lmax 8001; phase
#: 12 "lss_bbn" the astro configuration with DES, SZ, BBN and BAO; phase
#: 13 "driver" action 0 of `python -m cosmomc_tpu_torch` on the flagship
#: ini; phase 14 "gradient" the gradient of phase 12's configuration and
#: action 2 on it, the forward kernels with their reverse kernels; phase 15
#: "flagship_grad" the flagship's gradient and action 2 on its ini, the
#: four forward kernels and their four reverse kernels; phase 16
#: "mnu_grad" and "w0wa_grad" the gradients of base_mnu and of base_w_wa
#: with alpha1, K1's instantiation and its reverse kernel twice a gradient
#: (the source and the matter grids); phase 17 "lcdm_r_grad" LCDM+r's
#: gradient (the flagship's kernels, K5 and K6, and their six reverse
#: kernels); K1's fourth instantiation, boltzmann_nu_de, and its reverse
#: kernel are on no path: phase 2 holds them to their plain versions)
PATH_KERNELS = {"flagship": ("recfast", "boltzmann", "los", "lensing"),
                "lcdm_r": ("recfast", "boltzmann", "los_rec", "lensing",
                           "tensors", "tensor_los"),
                "runner": ("recfast", "boltzmann", "los", "lensing"),
                "background": (),
                "flagship_mp": ("recfast", "boltzmann", "los", "lensing"),
                "astro": ("recfast", "boltzmann"),
                "mnu": ("recfast", "boltzmann_nu", "los", "lensing"),
                "w0wa": ("recfast", "boltzmann_de", "los", "lensing"),
                "spt": ("recfast", "boltzmann", "los", "lensing"),
                "lss_bbn": ("recfast", "boltzmann"),
                "driver": ("recfast", "boltzmann", "los", "lensing"),
                "gradient": ("recfast", "boltzmann", "recfast_bwd",
                             "boltzmann_bwd"),
                "flagship_grad": ("recfast", "boltzmann", "los", "lensing",
                                  "recfast_bwd", "boltzmann_bwd", "los_bwd",
                                  "lensing_bwd"),
                "mnu_grad": ("recfast", "boltzmann_nu", "los", "lensing",
                             "recfast_bwd", "boltzmann_nu_bwd", "los_bwd",
                             "lensing_bwd"),
                "w0wa_grad": ("recfast", "boltzmann_de", "los", "lensing",
                              "recfast_bwd", "boltzmann_de_bwd", "los_bwd",
                              "lensing_bwd"),
                "lcdm_r_grad": ("recfast", "boltzmann", "los", "lensing",
                                "tensors", "tensor_los", "recfast_bwd",
                                "boltzmann_bwd", "los_bwd", "lensing_bwd",
                                "tensors_bwd", "tensor_los_bwd")}

#: NVIDIA H100 SXM data sheet: dense rates outside the tensor cores, the
#: FP64 tensor cores' rate, and the memory rate
PEAK_OPS = {"fp32": 67e12, "fp64": 34e12, "fp64_tensor": 67e12}
MEM_BYTES_PER_S = 3.35e12
#: operations per unit of work, counted from each kernel's plain version
#: unless said otherwise (a multiply-add counts as two, a divide, square
#: root, exp, log or pow as one):
OPS = {
    # per (chain, z step) from the first live node on (before it the state
    # is the table's): T_M step and 2 Newton iterations ~40, four rate
    # sets (pow, sqrt, exp) ~100, 3 + 3 Newton residuals of x_He, x_H ~140,
    # regime selection ~20 (models/recfast.py:_scan_plain)
    "recfast": 300,
    # per (chain, k, step): an RHS of ~285 (the non-frozen branch; frozen
    # lanes compute it and discard it), and 37 variables x 16 for the RK4
    # combinations + ~50 for the sources (models/perturbations.py:_rhs).
    # The plain version evaluates 5 RHS a step; the least arithmetic is 4
    # where a step's first table row repeats the previous step's last (the
    # fifth evaluation is then the next step's first), which phase 2 counts
    # from the table it runs
    "boltzmann": (285, 37 * 16 + 50),
    # the extended instantiations add to that, per RHS: massive nu, the
    # three node sums 32 (3, 2 and 3 a node), the switch and the three
    # stress terms 12, the 28 Psi derivatives 6 each and the l = 0, 2
    # sources 24 = 236; per step 28 more variables x 16 and the stress
    # derivative for the sources 32. DE fluid, per RHS: 2 stress terms 4
    # and the two derivatives 16 = 20; per step 2 variables x 16
    "boltzmann_nu": (285 + 236, (37 + 28) * 16 + 50 + 32),
    "boltzmann_de": (285 + 20, (37 + 2) * 16 + 50),
    # both extensions: the two sums
    "boltzmann_nu_de": (285 + 236 + 20, (37 + 28 + 2) * 16 + 50 + 32),
    # the least arithmetic that computes the function (csrc/cls.cu, where
    # j'' is folded into the j and j' coefficients): per (chain, l, k, tau)
    # point two lerps 6 and five multiply-adds 10; per (chain, k, tau) the
    # 4 x 4-point interpolation 28, the weights 4, x, index, fraction, 1 - f
    # 4, 1/x, 1/x^2 2, the folded coefficients 5
    "los": (16, 43),
    # its reverse (csrc/cls.cu los_bwd): per (chain, l, k, tau) point two
    # differences of table neighbours 2, l(l+1) G_T + G_E efac 2 and eight
    # multiply-adds 16; per (chain, k, tau) the forward's per-node terms 43
    # and the cotangents of the sources, x and the weights from the eight
    # sums ~45
    "los_bwd": (20, 88),
    # the least arithmetic that computes the function (models/cls.py:
    # _los_rec_plain, counted on the data phase 2 runs): per (chain, k,
    # tau, l) point on the live lattice (x above the Airy cut) the
    # recurrence 3: past a node's first dead l its j_l are 0 and need no
    # work, so the cut's compare and select are not counted; per point below
    # L0 (where x*x < l+1 can hold above the cut) the series term 3, its
    # polynomial 5 and its select 2; per (node, sampled l) where j_l or
    # j_{l-1} is nonzero the three sums 12 (regrouped onto four per-node
    # coefficients); per (chain, k, tau) node the 4 x 4-point interpolation
    # 28, the weights 4, x, 1/x, sin, cos, j_0, j_1 and the coefficients 18,
    # and the bisection for its first dead l, a compare and a select per
    # halving of l = 2..lmax (counted in phase 2). Two labelled
    # second bounds: `bound_ms_with_cut_selects` counts the compare and
    # select on every live point (5 a point), `bound_ms_whole_lattice` the
    # plain version's 15 on every point
    "los_rec": (3, 10, 12, 50),
    # per RHS evaluation re-read from models/tensors.py:_tensor_rhs (a
    # divide counted as the product csrc/tensors.cu takes): Psi 13 (its six
    # terms 11, the tight-coupling form 1, the select 1), the switches 3,
    # the stress 11, h'' 4, the Dt ladder 121, Dp 64, Dn 85 = 301; on a
    # tight-coupling row (QT_TC) the Dt and Dp ladders are frozen and pi_g
    # is 0 (_tensor_rhs:161, 187-189): Psi 1, the switches 3, the stress 8,
    # h'' 4, Dn 85 = 101; past the freeze (k tau >= 240) h'' 8; per step 45
    # variables x 15 (RK4) + 10 (step, sources). Counted on the table phase
    # 2 runs: 4 evaluations a released step where its first row repeats the
    # row before (5 otherwise), the source evaluation alone where the lane
    # is not released (the RK4 result is discarded)
    "tensors": (301, 101, 8, 45 * 15 + 10),
    # the least arithmetic that computes the function (csrc/tensor_los.cu,
    # where j'' is folded into the j and j' coefficients), counted on the
    # live lattice of the data phase 2 runs (models/tensors.py:tlos_lattice:
    # the points whose four table entries are not all 0): per live (chain,
    # l, k, tau) point two lerps 6, the coefficient of j in E 2 and five
    # multiply-adds 10; per (chain, k, tau) node the two source lerps and
    # weights 8, x, the index and fraction 4, max(x, 1e-8), 1/x, 1/x^2 3,
    # the six folded coefficients 10. A labelled second bound, `bound_ms_whole_lattice`,
    # counts the plain version's 40 on every point of the whole lattice
    "tensor_los": (18, 25),
    # the reverse kernels tensors_bwd and tensor_los_bwd are bounded, as
    # the other reverse rows, by 3 x their forward's count on the same work
    # (phase2_reverse_tensors)
}


def lensing_ops(C, L, nth, nl_out):
    """FP64 operations of models/lensing.py:_passes_plain, which does the
    chain-independent work once per (theta, l): pass 1 15, pass 2 108 (the
    Legendre and three Jacobi recurrences, 15 Wigner-d's), pass 3 36 per
    output l; and per (chain, theta, l): pass 1 5, pass 2 84 (the exp, the
    X's and the four xi terms), pass 3 8 per output l. Pass 3's per-chain
    product is a contraction over theta, which csrc/lensing.cu runs on the
    FP64 tensor cores."""
    return {"fp64": nth * (L * (15 + 108) + nl_out * 36) + C * nth * L * (5 + 84),
            "fp64_tensor": C * nth * nl_out * 8}


def k5_ops(qt, k):
    """FP32 operations of one K5 solve on the stage table qt (C, S, R, NQT)
    and wavenumbers k, by OPS["tensors"] (the tight-coupling rows, the rows
    past the freeze, the held steps and the repeated rows counted from the
    table)."""
    from cosmomc_tpu_torch.models import tensors as mten
    per_rhs, per_tc, per_frozen, per_step = OPS["tensors"]
    tau = qt[..., mten.QT_TAU]                                # (C, S, R)
    kk = k.to(qt.dtype)
    tc = (qt[..., mten.QT_TC] > 0.5)[..., None]
    rhs = torch.where(kk * tau[..., None] >= mten.RSA_KTAU_T, per_frozen,
                      torch.where(tc, per_tc, per_rhs))
    R = qt.shape[2]
    repeats = torch.zeros(qt.shape[:2], dtype=torch.bool, device=qt.device)
    repeats[:, 1:] = (qt[:, 1:, 0] == qt[:, :-1, -1]).all(-1)
    # a released step: every stage row (rows 3s + 1 twice), the first row
    # unless it repeats, and the source evaluation at the last row
    stages = rhs[:, :, 1:R - 1].sum(2) + rhs[:, :, 1:R - 1:3].sum(2) \
        + torch.where(repeats[..., None], 0, rhs[:, :, 0])
    released = kk * tau[:, :, -1, None] >= mten.RELEASE_KTAU_T
    per = torch.where(released, stages + per_step, 0) + rhs[:, :, -1]
    return int(per.sum())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, moved):
    """The least time the card could take (ms), the larger of the
    operations over the peak rate of their type (`ops`: type -> count; the
    types' times add) and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    t_mem = moved / MEM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_mem),
                bound_by="operations" if t_ops >= t_mem else "bytes",
                ops={kind: float(n) for kind, n in ops.items()},
                bytes=float(moved))


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def timed(fn, reps=1):
    """Mean milliseconds of `reps` calls, by CUDA events (after the caller's
    warm-up), and the last result."""
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_f32(name, k32, p32, r64, floor):
    """float32 kernel vs the float64 plain result on the same inputs: no
    less accurate than the float32 plain version (or within `floor`)."""
    ek, ep = rel_err(k32, r64), rel_err(p32, r64)
    log(f"  {name:10s} f32 kernel err {ek:.3e}  f32 plain err {ep:.3e} "
        f"(vs f64 plain)  |kernel-plain| {abs_err(k32, p32):.3e}")
    require(ek <= max(2.0 * ep, floor), f"{name} float32 accuracy")
    return abs_err(k32, p32)


def check_f64(name, k64, p64):
    e = rel_err(k64, p64)
    log(f"  {name:10s} f64 kernel vs plain rel err {e:.3e} (tol 1e-9)")
    require(e <= 1e-9, f"{name} float64 agreement")


def bestfit_vector(post, point=None):
    """The varying vector at BESTFIT and `point` (centres for the rest)."""
    at = {**BESTFIT, **(point or {})}
    return np.array([at.get(p.name, p.center) for p in post.space.varying])


class plain_version:
    """Within the block, `module.name` (a CUDA wrapper) is its plain twin:
    `module.twin`, by default the name with "plain" for "cuda"."""
    def __init__(self, module, name, twin=None):
        self.module, self.name = module, name
        self.twin = twin or name.replace("cuda", "plain")

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, getattr(self.module, self.twin))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def start_points(post, rng, dtype, point=None):
    P0 = np.tile(bestfit_vector(post, point), (NCHAINS, 1))
    sig = np.array([p.propose_width for p in post.space.varying])
    P0 += 0.3 * sig * rng.standard_normal(P0.shape)
    lo = np.array([p.min for p in post.space.varying])
    hi = np.array([p.max for p in post.space.varying])
    return torch.as_tensor(np.clip(P0, lo, hi), dtype=dtype, device=post.device)


def k1_ops(qt, nk, name="boltzmann"):
    """FP32 operations of one K1 solve on the stage table qt (C, S, 3, NQ)
    for nk wavenumbers, by OPS[name] (the instantiation): 5 RHS a step, 4
    where the step's first row repeats the row before."""
    per_rhs, per_step = OPS[name]
    repeats = (qt[:, 1:, 0] == qt[:, :-1, 2]).all(-1).sum(-1)
    return int(((5 * qt.shape[1] - repeats) * per_rhs
                + qt.shape[1] * per_step).sum()) * nk


def k1_against_plain(name, q, k, rnu):
    """K1 against its plain version on the float32 stage table q: float64
    (the table upcast; that one plain run is also the float32 reference)
    and float32 (kernel timed over 3 launches, plain once). Returns the
    float32 |kernel - plain| maximum, both times and the float32 inputs and
    kernel output."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    q32, k32, rnu32 = q.float(), k.float(), rnu.float()
    up = (q32.double(), k32.double(), rnu32.double(), mpert.RSA_KTAU)
    o_r = mpert._evolve_plain(*up)
    check_f64(name, mpert._evolve_cuda(*up), o_r)
    mpert._evolve_cuda(q32, k32, rnu32, mpert.RSA_KTAU)
    ms, o_k = timed(lambda: mpert._evolve_cuda(q32, k32, rnu32,
                                               mpert.RSA_KTAU), reps=3)
    plain_ms, o_p = timed(lambda: mpert._evolve_plain(q32, k32, rnu32,
                                                      mpert.RSA_KTAU))
    err = max(check_f32(f"{name}.{n}", o_k[i], o_p[i], o_r[i], 1e-3)
              for i, n in enumerate(mpert.PLANES))
    return err, ms, plain_ms, (q32, k32, rnu32, o_k)


def check_f32_floor(name, k32, r64, floor):
    """float32 kernel vs the float64 plain result on the same inputs,
    within `floor` of the plane's maximum; returns |kernel - plain|."""
    e = rel_err(k32, r64)
    log(f"  {name:14s} f32 kernel err {e:.3e} (vs f64 plain; floor {floor})")
    require(e <= floor, f"{name} float32 accuracy")
    return abs_err(k32, r64)


def k1_variant_plain(q, k, rnu, sw, iso=None):
    """The plain version of an extended K1 instantiation, once, in float64
    on the float32 inputs upcast: (milliseconds, planes)."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    up = (q.float().double(), k.float().double(), rnu.float().double(),
          mpert.RSA_KTAU, *sw)
    iso_u = None if iso is None else iso.float().double()
    return timed(lambda: mpert._evolve_plain(*up, iso=iso_u))


def k1_variant_against_plain(name, q, k, rnu, sw, iso=None, ref=None):
    """An extended K1 instantiation (sw = (massive_nu, de_perts)) against
    its plain version on the float32 stage table q: the plain version once,
    in float64 on the float32 inputs upcast (`k1_variant_plain`, timed; or
    `ref`, its result from the `--plain-card` process), holds the float64
    kernel (1e-9) and the float32 kernel (K1_VARIANT_F32_FLOOR); the
    float32 kernel timed over 3 launches. Returns the float32 |kernel -
    plain| maximum, both times and the float32 inputs and kernel output."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    q32, k32, rnu32 = q.float(), k.float(), rnu.float()
    iso32 = None if iso is None else iso.float()
    iso_u = None if iso is None else iso32.double()
    up = (q32.double(), k32.double(), rnu32.double(), mpert.RSA_KTAU, *sw)
    plain_ms, o_r = ref if ref is not None else k1_variant_plain(q, k, rnu, sw, iso)
    check_f64(name, mpert._evolve_cuda(*up, iso=iso_u), o_r)

    def kern():
        return mpert._evolve_cuda(q32, k32, rnu32, mpert.RSA_KTAU, *sw, iso=iso32)
    kern()
    ms, o_k = timed(kern, reps=3)
    err = max(check_f32_floor(f"{name}.{n}", o_k[i], o_r[i], K1_VARIANT_F32_FLOOR)
              for i, n in enumerate(mpert.PLANES))
    return err, ms, plain_ms, (q32, k32, rnu32, iso32, o_k)


def phase2(dev, results):
    """Each kernel against its plain version at main-path shapes."""
    from cosmomc_tpu_torch.models import cls as mcls
    from cosmomc_tpu_torch.models import lensing as mlens
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models import recfast as mrec
    from cosmomc_tpu_torch.models import tensors as mten
    from cosmomc_tpu_torch.models.background import BG_FIELDS
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.cmb import source_k_grid
    from cosmomc_tpu_torch.models.primordial import PrimordialParams
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization

    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (NCHAINS, 1))
    for name in ("ombh2", "omch2", "theta", "tau"):
        full[:, space.index(name)] = BESTFIT[name] * (
            1 + 0.002 * rng.standard_normal(NCHAINS))
    full = torch.as_tensor(full, dtype=F64, device=dev)
    bg = par.to_background(full)
    tab = synthetic_bbn_table().to(dev, F64)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, tab)

    # ---- K4: recfast, 8 chains x 8000 z steps
    log("K4 recfast: 8 chains x 8000 steps")
    fHe = yhe / (mrec.const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = mrec.const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt64 = mrec._z_tables(bg, mrec.z_grid(mrec.N_Z, dev, F64), fHe,
                          Nnow).contiguous()
    # one plain float64 run, on the float32 tables upcast, serves the
    # float64 check and the float32 reference
    zt32, f32 = zt64.float(), fHe.float()
    r64 = mrec._scan_plain(zt32.double(), f32.double())
    for a, b, n in zip(mrec._scan_cuda(zt32.double(), f32.double()), r64,
                       ("xe", "tm")):
        check_f64("recfast." + n, a, b)
    mrec._scan_cuda(zt32, f32)
    ms, k32 = timed(lambda: mrec._scan_cuda(zt32, f32), reps=10)
    plain_ms, p32 = timed(lambda: mrec._scan_plain(zt32, f32))
    err = max(check_f32("recfast." + n, a, b, c, 1e-4)
              for a, b, c, n in zip(k32, p32, r64, ("xe", "tm")))
    C, _, N = zt32.shape
    live = mrec.first_live_node(zt32)
    log(f"  first live node per chain: {live.tolist()} of {N}")
    z1, f1 = zt32[:1].contiguous(), f32[:1].contiguous()
    mrec._scan_cuda(z1, f1)
    serial_ms, _ = timed(lambda: mrec._scan_cuda(z1, f1), reps=10)
    results["recfast"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              serial_ms=serial_ms, **bound(
                                  {"fp32": int((N - live).sum()) * OPS["recfast"]},
                                  nbytes(zt32, f32, *k32)))
    log(f"  recfast kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, one chain "
        f"{serial_ms:.3f} ms (one dependency chain)")

    # ---- K1: Boltzmann, 8 chains x 248 k; compared at n_step=2048 (the
    # plain version launches ~1e3 ops a step; at 1024 steps the top k lanes
    # of the kmax=0.5 grid are past RK4's stability limit in float32)
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    kgrid = source_k_grid(kmax=0.5)
    k = torch.as_tensor(kgrid, dtype=F64, device=dev)
    log(f"K1 boltzmann: 8 chains x {len(kgrid)} k; compare at {K1_CMP_STEPS} steps")
    tf1, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=K1_CMP_STEPS)
    rnu = mpert._r_nu(bg).contiguous()
    err, ms, plain_ms, (q32, k32_, rnu32, o_k) = k1_against_plain(
        "boltzmann", mpert._stage_tables(bg, tf1), k, rnu)
    log(f"  boltzmann@{K1_CMP_STEPS} kernel {ms:.2f} ms, plain {plain_ms:.1f} ms")
    k1_bound = bound({"fp32": k1_ops(q32, k.shape[0])},
                     nbytes(q32, k32_, rnu32, o_k))
    q1l, k1l, r1l = q32[:1].contiguous(), k32_[-1:].contiguous(), rnu32[:1].contiguous()
    mpert._evolve_cuda(q1l, k1l, r1l, mpert.RSA_KTAU)
    serial_ms, _ = timed(lambda: mpert._evolve_cuda(q1l, k1l, r1l, mpert.RSA_KTAU), 3)
    log(f"  boltzmann@{K1_CMP_STEPS} one lane {serial_ms:.2f} ms (one dependency chain)")
    tf, tau0 = mpert.build_thermo_funcs(bg, yhe, th, zre)
    q = mpert._stage_tables(bg, tf)
    ms_full = {}
    for dt in (F32, F64):
        qd, kd, rd = q.to(dt), k.to(dt), rnu.to(dt)
        mpert._evolve_cuda(qd, kd, rd, mpert.RSA_KTAU)
        ms_full[dt], _ = timed(lambda: mpert._evolve_cuda(qd, kd, rd,
                                                          mpert.RSA_KTAU), 5)
    full_bound = bound({"fp32": k1_ops(q.float(), k.shape[0])}, 0)["bound_ms"]
    log(f"  boltzmann@8192 kernel f32 {ms_full[F32]:.2f} ms (bound "
        f"{full_bound:.3f} ms), f64 {ms_full[F64]:.2f} ms")
    results["boltzmann"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                ms_8192_steps=ms_full[F32],
                                bound_ms_8192_steps=full_bound,
                                serial_ms=serial_ms, **k1_bound)

    # ---- K2a: LOS at 109 l x 4521 k x 2048 tau, from the 8192-step sources
    log("K2a los: 8 chains, lmax 2658, kmax 0.5, tau stride 4")
    po64 = mpert.evolve_perturbations(bg, tf, tau0, k)
    ipk = torch.argmax(tf.vis, -1, keepdim=True)
    chi = tau0 - tf.tau.gather(-1, ipk)[:, 0]
    args = dict(coarse_k=kgrid, lmax=2658, kmax_hint=0.5, tau_stride=4)
    fields = ("tau", "k", "s0", "s1", "s2", "slens", "tau0")
    cast = lambda po, dt: po._replace(**{f: getattr(po, f).to(dt)
                                         for f in fields})
    clt_k64 = mcls.compute_cl_transfers(po64, chi, **args)
    with plain_version(mcls, "_los_cuda", "_los_plan_plain"):
        clt_p64 = mcls.compute_cl_transfers(po64, chi, **args)
    for f in ("dT", "dE", "dP"):
        check_f64("los." + f, getattr(clt_k64, f), getattr(clt_p64, f))
    po32, chi32 = cast(po64, F32), chi.float()
    mcls.compute_cl_transfers(po32, chi32, **args)   # builds the float32 plan
    ms, clt_k = timed(lambda: mcls.compute_cl_transfers(po32, chi32, **args), 3)
    with plain_version(mcls, "_los_cuda", "_los_plan_plain"):
        plain_ms, clt_p = timed(lambda: mcls.compute_cl_transfers(po32, chi32,
                                                                  **args))
        clt_r = mcls.compute_cl_transfers(cast(po32, F64), chi32.double(),
                                          **args)
    err = max(check_f32("los." + f, getattr(clt_k, f), getattr(clt_p, f),
                        getattr(clt_r, f), 1e-4) for f in ("dT", "dE", "dP"))
    C, nl, nkf = clt_k.dT.shape
    nt = len(range(0, po32.tau.shape[-1], args["tau_stride"]))
    nx = mcls._plan(2658, 14200.0, 0.5, 4.0, 256,
                    tuple(np.asarray(kgrid, np.float64).tolist())).jl.shape[1]
    per_pt, per_knode = OPS["los"]
    results["los"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(
        {"fp32": C * nkf * nt * (nl * per_pt + per_knode)},
        4 * (C * 4 * len(kgrid) * nt + 2 * nl * nx + 3 * C * nt + 3 * C * nl * nkf)))
    log(f"  los kernel {ms:.1f} ms, plain {plain_ms:.1f} ms "
        f"(both incl. the wrapper's source striding/weights)")

    # ---- K3: lensing, l = 2..2658, 5315 theta, 8 chains
    log("K3 lensing: 8 chains, lmax 2658 -> 2508, 5315 theta")
    pp = PrimordialParams.make(logA=torch.full((NCHAINS,), 3.0447, dtype=F64,
                                               device=dev),
                               ns=torch.full((NCHAINS,), 0.9659, dtype=F64,
                                             device=dev))
    raw = mcls.cls_from_cl_transfers(clt_k64, pp, lmax=2658)
    st64 = [raw.tt * MUK2, raw.te * MUK2, raw.ee * MUK2, raw.pp]
    out_k64 = mlens.lens_cls(raw.ls, *st64, lmax_lensed=2508)
    with plain_version(mlens, "_passes_cuda", "_passes_grid_plain"):
        out_p64 = mlens.lens_cls(raw.ls, *st64, lmax_lensed=2508)
    for f in ("tt", "te", "ee", "bb"):
        check_f64("lensing." + f, getattr(out_k64, f), getattr(out_p64, f))
    st32 = [x.float() for x in st64]
    mlens.lens_cls(raw.ls, *st32, lmax_lensed=2508)
    ms, out_k = timed(lambda: mlens.lens_cls(raw.ls, *st32, lmax_lensed=2508), 5)
    again = mlens.lens_cls(raw.ls, *st32, lmax_lensed=2508)
    with plain_version(mlens, "_passes_cuda", "_passes_grid_plain"):
        plain_ms, out_p = timed(lambda: mlens.lens_cls(raw.ls, *st32,
                                                       lmax_lensed=2508))
        out_r = mlens.lens_cls(raw.ls, *[x.double() for x in st32],
                               lmax_lensed=2508)
    for f in ("tt", "te", "ee", "bb"):
        require(torch.equal(getattr(out_k, f), getattr(again, f)),
                f"lensing.{f} repeatable bit for bit")
    err = max(check_f32("lensing." + f, getattr(out_k, f), getattr(out_p, f),
                        getattr(out_r, f), 1e-4) for f in ("tt", "te", "ee", "bb"))
    C, L = st32[0].shape
    nth, nl_out = 2 * (L + 1) - 1, 2508 - 1
    results["lensing"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(
        lensing_ops(C, L, nth, nl_out),
        4 * C * 4 * L + 8 * 7 * nth + 4 * C * nl_out * 4))
    log(f"  lensing kernel {ms:.2f} ms, plain {plain_ms:.1f} ms")

    # ---- K2b: recurrence LOS at K2a's shape (8 chains, 109 l x 4521 k x
    # 2048 tau, l walked 2..2658) on the float32 sources of the 8192-step
    # solve; the float64 check runs on those sources upcast, so one plain
    # run serves both checks
    log("K2b los_rec: 8 chains, lmax 2658, kmax 0.5, tau stride 4")

    def rec(po, c):
        return mcls.compute_cl_transfers_recurrence(po, c, **args)
    po_u, chi_u = cast(po32, F64), chi32.double()
    k64 = rec(po_u, chi_u)
    with plain_version(mcls, "_los_rec_cuda"):
        r64 = rec(po_u, chi_u)
    for f in ("dT", "dE", "dP"):
        check_f64("los_rec." + f, getattr(k64, f), getattr(r64, f))
    rec(po32, chi32)
    ms, ck = timed(lambda: rec(po32, chi32), 3)
    again = rec(po32, chi32)
    with plain_version(mcls, "_los_rec_cuda"):
        plain_ms, cp = timed(lambda: rec(po32, chi32))
    for f in ("dT", "dE", "dP"):
        require(torch.equal(getattr(ck, f), getattr(again, f)),
                f"los_rec.{f} repeatable bit for bit")
    err = max(check_f32("los_rec." + f, getattr(ck, f), getattr(cp, f),
                        getattr(r64, f), 1e-4) for f in ("dT", "dE", "dP"))
    C, nl, nkf = ck.dT.shape
    ls_h, kf_h, _, _, _, cut_h = mcls._rec_plan(
        2658, 14200.0, 0.5, 4.0, tuple(np.asarray(kgrid, np.float64).tolist()))
    _, chi_arg, _, _ = mcls._los_inputs(po32, chi32, args["tau_stride"])
    lat = mcls.rec_lattice(chi_arg, torch.as_tensor(kf_h, dtype=F32, device=dev),
                           torch.as_tensor(cut_h, dtype=F32, device=dev),
                           torch.as_tensor(ls_h, device=dev))
    l0 = mcls.rec_l0(2658, F32)
    nodes = C * nkf * nt
    per_live, per_series, per_sample, per_node = OPS["los_rec"]
    per_node += 2 * math.ceil(math.log2(len(cut_h) - 2))   # the bisection
    rest = per_series * nodes * (l0 - 2) + per_sample * lat["sampled"] \
        + per_node * nodes
    moved = 4 * (C * 4 * len(kgrid) * nt + 3 * C * nt + 3 * C * nl * nkf)
    log(f"  los_rec lattice {lat['lattice']}: live {lat['live']} "
        f"({lat['live'] / lat['lattice']:.4f}), walked {lat['walked']} "
        f"({lat['walked'] / lat['lattice']:.4f}); L0 {l0}; "
        f"(node, sampled l) pairs {lat['sampled']}")
    results["los_rec"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, lattice=lat, l0=l0,
        bound_ms_with_cut_selects=bound({"fp32": 5 * lat["live"] + rest},
                                        moved)["bound_ms"],
        bound_ms_whole_lattice=bound({"fp32": lat["lattice"] * 15}, moved)["bound_ms"],
        **bound({"fp32": per_live * lat["live"] + rest}, moved))
    r = results["los_rec"]
    log(f"  los_rec kernel {ms:.1f} ms, plain {plain_ms:.1f} ms; bound "
        f"{r['bound_ms']:.3f} ms ({r['ops']['fp32']:.4e} ops), with the cut's "
        f"selects {r['bound_ms_with_cut_selects']:.3f}, whole lattice "
        f"{r['bound_ms_whole_lattice']:.3f}; the table engine (K2a) at the "
        f"same shape {results['los']['ms']:.1f} ms")

    # ---- K5: tensor RK4, 8 chains x 96 k; held to its plain version on the
    # 2048-step grid (upcast float32 tables for the float64 check), timed at
    # 8192 steps as well (the main path)
    kt = torch.as_tensor(mten.tensor_k_grid(), dtype=F64, device=dev)
    log(f"K5 tensors: 8 chains x {kt.shape[0]} k; compare at {K1_CMP_STEPS} steps")
    q32, kt32 = mten._stage_table(bg, tf1, 1).float(), kt.float()
    q_u, kt_u = q32.double(), kt32.double()
    o64 = mten._evolve_t_cuda(q_u, kt_u, 1, True)
    r64 = mten._evolve_t_plain(q_u, kt_u, 1, True)
    for i, n in enumerate(mten.T_PLANES):
        check_f64("tensors." + n, o64[i], r64[i])
    mten._evolve_t_cuda(q32, kt32, 1, True)
    ms, o_k = timed(lambda: mten._evolve_t_cuda(q32, kt32, 1, True), 3)
    plain_ms, o_p = timed(lambda: mten._evolve_t_plain(q32, kt32, 1, True))
    err = max(check_f32("tensors." + n, o_k[i], o_p[i], r64[i], 1e-4)
              for i, n in enumerate(mten.T_PLANES))
    ms_full = {}
    for dt in (F32, F64):
        qd, kd = mten._stage_table(bg, tf, 1).to(dt), kt.to(dt)
        mten._evolve_t_cuda(qd, kd, 1, True)
        ms_full[dt], _ = timed(lambda: mten._evolve_t_cuda(qd, kd, 1, True), 2)
    log(f"  tensors@{K1_CMP_STEPS} kernel {ms:.2f} ms, plain {plain_ms:.1f} ms; "
        f"@8192 kernel f32 {ms_full[F32]:.1f} ms, f64 {ms_full[F64]:.1f} ms")
    q1l, k1l = q32[:1].contiguous(), kt32[-1:].contiguous()
    mten._evolve_t_cuda(q1l, k1l, 1, True)
    serial_ms, _ = timed(lambda: mten._evolve_t_cuda(q1l, k1l, 1, True), 3)
    log(f"  tensors@{K1_CMP_STEPS} one lane {serial_ms:.2f} ms (one dependency chain)")
    q8192 = mten._stage_table(bg, tf, 1).float()
    results["tensors"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, ms_8192_steps=ms_full[F32],
        bound_ms_8192_steps=bound({"fp32": k5_ops(q8192, kt32)}, 0)["bound_ms"],
        serial_ms=serial_ms, **bound({"fp32": k5_ops(q32, kt32)},
                                     nbytes(q32, kt32, *o_k)))
    log(f"  tensors bound {results['tensors']['bound_ms']:.4f} ms, @8192 "
        f"{results['tensors']['bound_ms_8192_steps']:.4f} ms; tight-coupling "
        f"rows @8192 {float((q8192[..., mten.QT_TC] > 0.5).float().mean()):.4f}")

    # ---- K6: tensor LOS, 8 chains x 65 l x 610 k x 8192 tau, on K5's
    # float32 output of the 8192-step solve; the float64 check runs on those
    # sources upcast
    log("K6 tensor_los: 8 chains, lmax 700, on K5's 8192-step sources")
    tf32 = tf._replace(**{f: getattr(tf, f).float() for f in tf._fields})
    bg32 = type(bg)(**{f: getattr(bg, f).float() for f in BG_FIELDS},
                    num_massive_nu=bg.num_massive_nu)
    to32 = mten.evolve_tensors(bg32, tf32, tau0.float(), kt32)
    to_u = to32._replace(**{f: getattr(to32, f).double()
                            for f in ("tau", "k", "sT", "sP", "tau0")})
    kgrid_t = mten.tensor_k_grid()

    def tlos(to):
        return mten.compute_tensor_transfers(to, coarse_k=kgrid_t)
    c64 = tlos(to_u)
    with plain_version(mten, "_tlos_cuda"):
        r64 = tlos(to_u)
    for f in ("dT", "dE", "dB"):
        check_f64("tensor_los." + f, getattr(c64, f), getattr(r64, f))
    tlos(to32)
    ms, ck = timed(lambda: tlos(to32), 5)
    again = tlos(to32)
    with plain_version(mten, "_tlos_cuda"):
        plain_ms, cp = timed(lambda: tlos(to32))
    for f in ("dT", "dE", "dB"):
        require(torch.equal(getattr(ck, f), getattr(again, f)),
                f"tensor_los.{f} repeatable bit for bit")
    err = max(check_f32("tensor_los." + f, getattr(ck, f), getattr(cp, f),
                        getattr(r64, f), 1e-4) for f in ("dT", "dE", "dB"))
    targs, _ = mten._tlos_inputs(to32, 700, 14700.0, 0.065, 4.0, kgrid_t)
    alone_ms, _ = timed(lambda: mten._tlos_cuda(*targs), 5)
    C, nl, nkf = ck.dT.shape
    N = to32.tau.shape[-1]
    tabs = mten._TLOS_BY_TABLE[id(targs[7])]
    lat = mten.tlos_lattice(targs[5], targs[4], tabs["n0"], nl,
                            targs[7].shape[1], targs[10])
    per_live, per_node = OPS["tensor_los"]
    moved = nbytes(to32.tau, to32.sT, to32.sP, targs[7], targs[8], ck.dT, ck.dE,
                   ck.dB)
    results["tensor_los"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, kernel_alone_ms=alone_ms,
        lattice=lat, bound_ms_whole_lattice=bound(
            {"fp32": 40 * lat["lattice"]}, moved)["bound_ms"],
        **bound({"fp32": per_live * lat["live"] + per_node * C * nkf * N}, moved))
    r = results["tensor_los"]
    log(f"  tensor_los lattice {lat['lattice']}: live {lat['live']} "
        f"({lat['live'] / lat['lattice']:.4f}), walked {lat['walked']} "
        f"({lat['walked'] / lat['lattice']:.4f})")
    log(f"  tensor_los kernel {ms:.3f} ms with the wrapper, {alone_ms:.3f} ms "
        f"alone, plain {plain_ms:.1f} ms; bound {r['bound_ms']:.4f} ms "
        f"({r['ops']['fp32']:.4e} ops), whole lattice at 40 a point "
        f"{r['bound_ms_whole_lattice']:.4f} ms")
    # what the reverse checks of K2a and K3 read (phase2_reverse_cmb)
    return dict(po64=po64, chi=chi, kgrid=kgrid, st64=st64, ls=raw.ls)


def phase2_matter(dev, results):
    """K1 on the matter grid (matter_k_grid(): 216 k to 8/Mpc), one chain
    at the best fit: against its plain version at the first bounded step
    count of MATTER_CMP_STEPS, timed and bounded at that count and at the
    6144 steps of compute_matter_transfers, and float32 against float64
    through compute_matter_transfers / matter_power_from_transfers at 6144
    steps (every lane finite; sigma8(z), f sigma8(z) within 0.5%)."""
    from cosmomc_tpu_torch.models import matterpower as mpw
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.primordial import PrimordialParams
    from cosmomc_tpu_torch.models.recfast import compute_thermo
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization

    par = ThetaParameterization()
    space = par.default_space()
    full = np.array([[BESTFIT.get(p.name, p.center) for p in space.params]])
    tab = synthetic_bbn_table()
    kgrid = mpw.matter_k_grid()
    kmax = float(kgrid[-1])

    def inputs(dt):
        P = torch.as_tensor(full, dtype=dt, device=dev)
        bg = par.to_background(P)
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, tab.to(dev, dt))
        return (bg, yhe, compute_thermo(bg, yhe),
                zre_from_tau(bg, P[:, space.index("tau")], yhe))
    bg, yhe, th, zre = inputs(F64)
    k = torch.as_tensor(kgrid, dtype=F64, device=dev)
    rnu = mpert._r_nu(bg).contiguous()
    nk = len(kgrid)
    log(f"K1 boltzmann on the matter grid: 1 chain x {nk} k to {kmax:.4g}/Mpc")
    i_dm = mpert.PLANES.index("dm")
    for n in MATTER_CMP_STEPS:
        tf_n, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=n, kmax=kmax)
        q = mpert._stage_tables(bg, tf_n)
        big = {}
        for dt in (F32, F64):
            o = mpert._evolve_cuda(q.to(dt), k.to(dt), rnu.to(dt), mpert.RSA_KTAU)
            big[dt] = (float(o[i_dm].abs().max()) if bool(torch.isfinite(o).all())
                       else math.inf)
        log(f"  {n} steps: max |delta_m| (before normalisation) float32 "
            f"{big[F32]:.4g}, float64 {big[F64]:.4g}")
        if max(big.values()) < MATTER_BOUNDED:
            break
    else:
        require(False, "K1 bounded on the matter grid at some step count")
    log(f"  held to its plain version at {n} steps")
    err, ms, plain_ms, (q32, k32, rnu32, o_k) = k1_against_plain(
        "boltzmann.matter", q, k, rnu)
    cmp_bound = bound({"fp32": k1_ops(q32, nk)}, nbytes(q32, k32, rnu32, o_k))
    # at the 6144 steps compute_matter_transfers runs
    tf, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=6144, kmax=kmax)
    q = mpert._stage_tables(bg, tf)
    ms_full = {}
    for dt in (F32, F64):
        qd, kd, rd = q.to(dt), k.to(dt), rnu.to(dt)
        mpert._evolve_cuda(qd, kd, rd, mpert.RSA_KTAU)
        ms_full[dt], out = timed(lambda: mpert._evolve_cuda(qd, kd, rd,
                                                            mpert.RSA_KTAU), 5)
        if dt == F32:
            full_bound = bound({"fp32": k1_ops(qd, nk)}, nbytes(qd, kd, rd, out))
    # float32 against float64 through the matter-power path, 6144 steps
    sig, mem = {}, {}
    for dt in (F32, F64):
        bg_d, yhe_d, th_d, zre_d = inputs(dt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mt = mpw.compute_matter_transfers(bg_d, th_d, zre_d, yhe_d, Z_PK)
        torch.cuda.synchronize()
        mem[dt] = torch.cuda.max_memory_allocated() - base
        for f in ("delta_m_z", "weyl_z", "v_z"):
            require(bool(torch.isfinite(getattr(mt, f)).all()),
                    f"matter grid {f} finite in every lane ({str(dt)[6:]})")
        one = bg_d.H0.new_ones(1)
        pp = PrimordialParams.make(logA=one * BESTFIT["logA"],
                                   ns=one * BESTFIT["ns"])
        mp = mpw.matter_power_from_transfers(bg_d, pp, mt)
        sig[dt] = (mp.sigma8_z[0].double(), mp.fsigma8_z[0].double())
    e8 = float((sig[F32][0] / sig[F64][0] - 1).abs().max())
    efs8 = float((sig[F32][1] / sig[F64][1] - 1).abs().max())
    log(f"  sigma8(z) at z {Z_PK}: float32 "
        + " ".join(f"{v:.6f}" for v in sig[F32][0].tolist()) + "; float64 "
        + " ".join(f"{v:.6f}" for v in sig[F64][0].tolist()))
    log(f"  f sigma8(z): float32 " + " ".join(f"{v:.6f}" for v in sig[F32][1].tolist())
        + "; float64 " + " ".join(f"{v:.6f}" for v in sig[F64][1].tolist()))
    log(f"  float32 vs float64 at 6144 steps: sigma8 max rel {e8:.3e}, "
        f"f sigma8 max rel {efs8:.3e} (tol {SIGMA8_F32_TOL})")
    require(e8 < SIGMA8_F32_TOL and efs8 < SIGMA8_F32_TOL,
            "float32 sigma8 and f sigma8 within 0.5% of float64")
    log(f"  boltzmann.matter@{n} kernel {ms:.2f} ms (bound {cmp_bound['bound_ms']:.4f} ms), "
        f"plain {plain_ms:.1f} ms; @6144 kernel f32 {ms_full[F32]:.2f} ms (bound "
        f"{full_bound['bound_ms']:.4f} ms, {full_bound['bound_by']}), f64 "
        f"{ms_full[F64]:.2f} ms; compute_matter_transfers peak memory a chain "
        f"{mem[F32] / 2**20:.1f} MiB (float32), {mem[F64] / 2**20:.1f} MiB (float64)")
    results["boltzmann"]["matter_grid"] = dict(
        nk=nk, kmax=kmax, compare_steps=n, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=cmp_bound["bound_ms"],
        bound_by=cmp_bound["bound_by"], ms_6144_steps=ms_full[F32],
        ms_6144_steps_f64=ms_full[F64], bound_ms_6144_steps=full_bound["bound_ms"],
        max_memory_allocated_per_chain={"float32": mem[F32], "float64": mem[F64]},
        sigma8_f32_vs_f64=e8, fsigma8_f32_vs_f64=efs8)


class VariantInputs:
    """K1's extended instantiations' inputs on the source grid: 8 chains
    near BESTFIT with mnu 0.06..0.3 eV, w0 -0.8..-1.2 and wa -0.4..0.3
    across them, the stage tables' thermal functions at K1_CMP_STEPS and
    mpert.N_STEP steps, and an isocurvature amplitude of 0.2 on chain 0.
    `inputs(full, n_step, kmax)` builds the same for other points."""

    def __init__(self, dev):
        from cosmomc_tpu_torch.models import perturbations as mpert
        from cosmomc_tpu_torch.models.cmb import source_k_grid
        from cosmomc_tpu_torch.params.parameterizations import \
            ThetaParameterization
        self.dev, self.par = dev, ThetaParameterization()
        self.space = space = self.par.default_space()
        rng = np.random.default_rng(2)
        full = np.tile([p.center for p in space.params], (NCHAINS, 1))
        for name in ("ombh2", "omch2", "theta", "tau"):
            full[:, space.index(name)] = BESTFIT[name] * (
                1 + 0.002 * rng.standard_normal(NCHAINS))
        for name, lo, hi in (("mnu", 0.06, 0.3), ("w", -0.8, -1.2),
                             ("wa", -0.4, 0.3)):
            full[:, space.index(name)] = np.linspace(lo, hi, NCHAINS)
        self.full = full
        self.bg, self.tfs = self.inputs(full, (K1_CMP_STEPS, mpert.N_STEP))
        self.k = torch.as_tensor(source_k_grid(kmax=0.5), dtype=F64, device=dev)
        self.rnu = mpert._r_nu(self.bg).contiguous()
        self.b = torch.zeros(NCHAINS, dtype=F64, device=dev)
        self.b[0] = 0.2

    def inputs(self, full, n_step, kmax=0.5):
        from cosmomc_tpu_torch.models import perturbations as mpert
        from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
        from cosmomc_tpu_torch.models.recfast import compute_thermo
        from cosmomc_tpu_torch.models.reionization import zre_from_tau
        P = torch.as_tensor(full, dtype=F64, device=self.dev)
        bg = self.par.to_background(P)
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046,
                      synthetic_bbn_table().to(self.dev, F64))
        th = compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, P[:, self.space.index("tau")], yhe)
        return bg, {n: mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=n,
                                                kmax=kmax)[0] for n in n_step}


def phase2_nu_de(dev, results, vi=None, ref=None):
    """K1's fourth instantiation (massive nu and the DE fluid together,
    `boltzmann_nu_de`) against its plain version run once in float64 on
    the float32 inputs upcast, at the width of phase2_variants' other
    instantiations: VariantInputs' NCHAINS chains (mnu 0.06 to 0.3 eV,
    w0 -0.8 to -1.2, wa -0.4 to 0.3; isocurvature 0.2 on chain 0) x the
    248 k of the source grid at K1_CMP_STEPS steps (kernel f64 1e-9, f32
    within K1_VARIANT_F32_FLOOR), timed and bounded there; then the kernel
    alone at 8192 steps."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    vi = vi or VariantInputs(dev)
    sw = (True, True)
    nk = vi.k.shape[0]
    shape = f"{NCHAINS} chains x {nk} k x {K1_CMP_STEPS} steps"
    log(f"K1 boltzmann_nu_de: compare at {shape} (isocurvature b = 0.2 on "
        "chain 0)")
    iso = mpert.iso_inputs(vi.bg, vi.b)
    err, ms, plain_ms, (q32, k32, rnu32, iso32, o_k) = k1_variant_against_plain(
        "boltzmann_nu_de", mpert._stage_tables(vi.bg, vi.tfs[K1_CMP_STEPS], *sw),
        vi.k, vi.rnu, sw, iso, ref=ref)
    cmp_bound = bound({"fp32": k1_ops(q32, nk, "boltzmann_nu_de")},
                      nbytes(q32, k32, rnu32, iso32, o_k))
    q = mpert._stage_tables(vi.bg, vi.tfs[mpert.N_STEP], *sw).float()
    mpert._evolve_cuda(q, k32, rnu32, mpert.RSA_KTAU, *sw, iso=iso32)
    ms_full, _ = timed(lambda: mpert._evolve_cuda(q, k32, rnu32, mpert.RSA_KTAU,
                                                  *sw, iso=iso32), 5)
    full_bound = bound({"fp32": k1_ops(q, nk, "boltzmann_nu_de")},
                       0)["bound_ms"]
    log(f"  boltzmann_nu_de@{shape}: kernel {ms:.3f} ms (bound "
        f"{cmp_bound['bound_ms']:.4f} ms), plain (float64) {plain_ms:.1f} ms; "
        f"@{mpert.N_STEP} steps: kernel {ms_full:.3f} ms (bound "
        f"{full_bound:.4f} ms)")
    results["boltzmann_nu_de"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, plain_dtype="float64",
        compare_shape=shape, ms_8192_steps=ms_full,
        bound_ms_8192_steps=full_bound, **cmp_bound)


def matter_nu_case(vi):
    """The massive-neutrino instantiation's matter-grid case: one chain at
    mnu 0.1 eV, w0 -0.9, wa -0.3 on matter_k_grid(), at the first step
    count of MATTER_CMP_STEPS where the kernel keeps every lane bounded in
    both precisions. Returns (bg, thermal functions, k, r_nu, that count,
    its stage table)."""
    from cosmomc_tpu_torch.models import matterpower as mpw
    from cosmomc_tpu_torch.models import perturbations as mpert
    kgrid = mpw.matter_k_grid()
    one = np.array([[{**BESTFIT, "mnu": 0.1, "w": -0.9, "wa": -0.3}.get(p.name, p.center)
                     for p in vi.space.params]])
    bg1, tfm = vi.inputs(one, MATTER_CMP_STEPS, float(kgrid[-1]))
    km = torch.as_tensor(kgrid, dtype=F64, device=vi.dev)
    rnu1 = mpert._r_nu(bg1).contiguous()
    i_dm = mpert.PLANES.index("dm")
    sw = (True, False)
    for n in MATTER_CMP_STEPS:
        q = mpert._stage_tables(bg1, tfm[n], *sw)
        big = {}
        for dt in (F32, F64):
            o = mpert._evolve_cuda(q.to(dt), km.to(dt), rnu1.to(dt), mpert.RSA_KTAU, *sw)
            big[dt] = (float(o[i_dm].abs().max()) if bool(torch.isfinite(o).all())
                       else math.inf)
        log(f"  boltzmann_nu, matter grid, {n} steps: max |delta_m| float32 "
            f"{big[F32]:.4g}, float64 {big[F64]:.4g}")
        if max(big.values()) < MATTER_BOUNDED:
            return bg1, tfm, km, rnu1, n, q
    require(False, "K1 boltzmann_nu bounded on the matter grid at some step count")


#: the plain versions that phase2_variants and phase2_nu_de hold K1's
#: extended instantiations to: (name, (massive_nu, de_perts), with the
#: isocurvature chain)
VARIANT_CASES = (("boltzmann_nu", (True, False), False),
                 ("boltzmann_de", (False, True), True),
                 ("boltzmann_nu_de", (True, True), True))


#: the plain versions each `--plain-card*` process computes: two
#: processes on the card beside phases 3-12, each loop bound by its
#: launches on the host
PLAIN_CARD_PARTS = {"--plain-card": ("boltzmann_nu", "boltzmann_nu.matter"),
                    "--plain-card-de": ("boltzmann_de", "boltzmann_nu_de")}


def variant_plain_refs(d, mode="--plain-card"):
    """--plain-card DIR (and --plain-card-de DIR): the plain versions of
    K1's extended instantiations named in PLAIN_CARD_PARTS[mode]
    (VARIANT_CASES on VariantInputs at K1_CMP_STEPS, and the massive-nu
    matter-grid case), float64 on the float32 inputs upcast, on the card:
    Python loops of ~2048 steps bound by their launches, so processes of
    their own run them beside the main one's phases 3-12 (started after
    phase 2, whose kernel timings they would share the card with). Writes
    DIR/plain_card.pt (DIR/plain_card_de.pt): each result on the host with
    its milliseconds (and the matter case's step count)."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    sys.path.insert(0, HERE)
    vi = VariantInputs(torch.device("cuda"))
    want = PLAIN_CARD_PARTS[mode]
    out = {}
    for name, sw, with_iso in VARIANT_CASES:
        if name not in want:
            continue
        iso = mpert.iso_inputs(vi.bg, vi.b) if with_iso else None
        ms, o = k1_variant_plain(mpert._stage_tables(vi.bg, vi.tfs[K1_CMP_STEPS], *sw),
                                 vi.k, vi.rnu, sw, iso)
        out[name] = (ms, o.cpu())
        print(f"{name} plain {ms:.1f} ms", flush=True)
    if "boltzmann_nu.matter" in want:
        _, _, km, rnu1, n, q = matter_nu_case(vi)
        ms, o = k1_variant_plain(q, km, rnu1, (True, False))
        out["boltzmann_nu.matter"] = (ms, o.cpu(), n)
        print(f"boltzmann_nu.matter plain {ms:.1f} ms at {n} steps", flush=True)
    torch.save(out, os.path.join(d, mode.strip("-").replace("-", "_") + ".pt"))
    return 0


def phase2_variants(dev, results, refs=None):
    """K1's extended instantiations on the main paths of phases 9 and 10,
    VariantInputs' 8 chains x 248 k on the source grid (the DE fluid also
    with its isocurvature chain): against the plain version at 2048 steps,
    timed and bounded there, on one lane and at 8192 steps; then the
    massive-neutrino instantiation on the matter grid (one chain at mnu
    0.1 eV) at the first bounded count of MATTER_CMP_STEPS, and both
    instantiations timed there at 6144 steps; then both extensions
    together (phase2_nu_de). `refs`: the plain versions from the
    `--plain-card` process (computed here when None)."""
    from cosmomc_tpu_torch.models import perturbations as mpert

    vi = VariantInputs(dev)
    bg, tfs, k, rnu, b = vi.bg, vi.tfs, vi.k, vi.rnu, vi.b
    nk = k.shape[0]

    def ref(name):
        if refs is None:
            return None
        return refs[name][0], refs[name][1].to(dev)
    for name, sw, with_iso in VARIANT_CASES[:2]:
        iso = mpert.iso_inputs(bg, b) if with_iso else None
        log(f"K1 {name}: {NCHAINS} chains x {nk} k; compare at {K1_CMP_STEPS} steps"
            + (" (isocurvature b = 0.2 on chain 0)" if iso is not None else ""))
        err, ms, plain_ms, (q32, k32, rnu32, iso32, o_k) = k1_variant_against_plain(
            name, mpert._stage_tables(bg, tfs[K1_CMP_STEPS], *sw), k, rnu, sw, iso,
            ref=ref(name))
        cmp_bound = bound({"fp32": k1_ops(q32, nk, name)},
                          nbytes(q32, k32, rnu32, o_k, *([iso32] if iso is not None else [])))
        one = lambda x: None if x is None else x[:1].contiguous()
        q1, k1, r1, i1 = one(q32), k32[-1:].contiguous(), one(rnu32), one(iso32)
        mpert._evolve_cuda(q1, k1, r1, mpert.RSA_KTAU, *sw, iso=i1)
        serial_ms, _ = timed(lambda: mpert._evolve_cuda(q1, k1, r1, mpert.RSA_KTAU,
                                                        *sw, iso=i1), 3)
        q = mpert._stage_tables(bg, tfs[mpert.N_STEP], *sw)
        ms_full = {}
        for dt in (F32, F64):
            qd, kd, rd = q.to(dt), k.to(dt), rnu.to(dt)
            idt = None if iso is None else iso.to(dt)
            mpert._evolve_cuda(qd, kd, rd, mpert.RSA_KTAU, *sw, iso=idt)
            ms_full[dt], _ = timed(lambda: mpert._evolve_cuda(
                qd, kd, rd, mpert.RSA_KTAU, *sw, iso=idt), 5)
        full_bound = bound({"fp32": k1_ops(q.float(), nk, name)}, 0)["bound_ms"]
        log(f"  {name}@{K1_CMP_STEPS} kernel {ms:.3f} ms (bound "
            f"{cmp_bound['bound_ms']:.4f} ms), plain (float64) {plain_ms:.1f} ms, one "
            f"lane {serial_ms:.3f} ms; @8192 kernel f32 {ms_full[F32]:.3f} ms (bound "
            f"{full_bound:.4f} ms), f64 {ms_full[F64]:.3f} ms")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             plain_dtype="float64", ms_8192_steps=ms_full[F32],
                             ms_8192_steps_f64=ms_full[F64],
                             bound_ms_8192_steps=full_bound, serial_ms=serial_ms,
                             **cmp_bound)

    # the matter grid: one chain at mnu 0.1 eV, w0 -0.9, wa -0.3
    bg1, tfm, km, rnu1, n, q = matter_nu_case(vi)
    kgrid, kmax = km.cpu().numpy(), float(km[-1])
    sw = (True, False)
    require(refs is None or refs["boltzmann_nu.matter"][2] == n,
            "the plain reference's matter-grid step count is the kernel's")
    err, ms, plain_ms, (q32, k32, rnu32, _, o_k) = k1_variant_against_plain(
        "boltzmann_nu.matter", q, km, rnu1, sw, ref=ref("boltzmann_nu.matter"))
    mg = dict(nk=len(kgrid), kmax=kmax, compare_steps=n, max_abs_err=err, ms=ms,
              plain_ms=plain_ms, **{f: v for f, v in bound(
                  {"fp32": k1_ops(q32, len(kgrid), "boltzmann_nu")},
                  nbytes(q32, k32, rnu32, o_k)).items() if f.startswith("bound")})
    log(f"  boltzmann_nu.matter@{n} kernel {ms:.3f} ms (bound {mg['bound_ms']:.4f} "
        f"ms), plain (float64) {plain_ms:.1f} ms")
    results["boltzmann_nu"]["matter_grid"] = mg
    for name, sw in (("boltzmann_nu", (True, False)), ("boltzmann_de", (False, True))):
        q = mpert._stage_tables(bg1, tfm[MATTER_CMP_STEPS[-1]], *sw).float()
        k32, r32 = km.float(), rnu1.float()
        mpert._evolve_cuda(q, k32, r32, mpert.RSA_KTAU, *sw)
        ms6, _ = timed(lambda: mpert._evolve_cuda(q, k32, r32, mpert.RSA_KTAU, *sw), 5)
        b6 = bound({"fp32": k1_ops(q, len(kgrid), name)}, 0)["bound_ms"]
        log(f"  {name}, matter grid @{MATTER_CMP_STEPS[-1]}: {ms6:.3f} ms (bound "
            f"{b6:.4f} ms)")
        results[name].setdefault("matter_grid", {}).update(
            ms_6144_steps=ms6, bound_ms_6144_steps=b6)
    phase2_nu_de(dev, results, vi, ref("boltzmann_nu_de"))


def write_theory_cl(path, cls):
    """CosmoMC theory_cl columns: L TT TE EE BB PP from a (4, 4, lmax+1)
    stack (l(l+1)C_l/2pi muK^2)."""
    c = cls.double().cpu().numpy()
    ls = np.arange(2, c.shape[-1])
    np.savetxt(path, np.column_stack([ls, c[0, 0, 2:], c[1, 0, 2:], c[1, 1, 2:],
                                      c[2, 2, 2:], c[3, 3, 2:]]))


def tensor_anchors(post, full, slow, dtype):
    """The tensor-only spectrum at the best fit (r = 0.1, nt = -r/8) against
    tests/test_tensors.py's anchors (CAMB r = 0.1): the BB recombination
    bump at 78 <= l <= 98 with 4e-3 < BB < 1.1e-2 muK^2, TT(l=10) in
    (35, 65) muK^2. Returns the tensor-only BB (l = 2..700)."""
    from cosmomc_tpu_torch.models.tensors import tensor_cls_from_transfers
    pp = post._primordial(full)
    tens = tensor_cls_from_transfers(slow["tt_cache"], pp,
                                     lmax=min(700, post.lmax))
    ls = tens.ls.cpu().numpy()
    bb = tens.bb[0].double().cpu().numpy() * MUK2
    tt = tens.tt[0].double().cpu().numpy() * MUK2
    ipk = int(np.argmax(bb[:300 - 2]))
    log(f"  tensor-only ({str(dtype)[6:]}), r={float(pp.r[0]):.3f}: BB peak "
        f"{bb[ipk]:.4e} muK^2 at l={ls[ipk]}, TT(l=10) {tt[ls == 10][0]:.2f} muK^2")
    require(78 <= ls[ipk] <= 98, "tensor BB bump at l 78..98")
    require(4e-3 < bb[ipk] < 1.1e-2, "tensor BB bump height")
    require(35.0 < tt[ls == 10][0] < 65.0, "tensor TT plateau at l=10")
    return torch.as_tensor(bb)


def instrument_stages(post):
    """Wrap post.stage_slow/semi/fast to count their calls and sum their
    wall time (synchronised); returns the two dicts they fill."""
    stage_s = {"slow": 0.0, "semi": 0.0, "fast": 0.0}
    calls = {"slow": 0, "semi": 0, "fast": 0}
    for name in stage_s:
        real = getattr(post, f"stage_{name}")

        def wrapped(*a, _real=real, _name=name):
            torch.cuda.synchronize()
            t0 = time.time()
            out = _real(*a)
            torch.cuda.synchronize()
            stage_s[_name] += time.time() - t0
            calls[_name] += 1
            return out
        setattr(post, f"stage_{name}", wrapped)
    return stage_s, calls


def drive_path(dev, tmp, label, cfg):
    """One main path at full width, float32, 8 chains: C_l at the best fit
    (float32 and float64), a plik_lite fiducial written from the float32
    ones, -logL there, then the sampler: init and one 16-step segment with
    one slow step. Returns the path's launch counts."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.params.space import Speed
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    par = ThetaParameterization()
    table = synthetic_bbn_table()
    log(f"path {label}: " + json.dumps(cfg))

    def posterior(likes, dtype):
        space = par.default_space()
        space.get("tau").prior_mean = 0.0544
        space.get("tau").prior_std = 0.0073
        return CMBPosterior(par, space, likes, bbn_table=table, device=dev,
                            dtype=dtype, **cfg)

    def at_bestfit(post, dtype):
        return torch.as_tensor(bestfit_vector(post)[None], dtype=dtype,
                               device=dev)

    # 1. C_l at the best fit through the port (float32 and float64)
    cls, tensor_bb = {}, {}
    for dt in (F32, F64):
        p0 = posterior(LikelihoodList(), dt)
        full = p0.embed_full(at_bestfit(p0, dt))
        t0 = time.time()
        slow = p0.stage_slow(full)
        cls[dt] = p0.stage_semi(full, slow)["cls"][0]
        if dt == F64:
            fid_theory = p0.assemble_theory(slow, dict(cls=None))
        torch.cuda.synchronize()
        log(f"C_l at best fit ({str(dt)[6:]}) {time.time() - t0:.2f} s")
        if p0.compute_tensors:
            tensor_bb[dt] = tensor_anchors(p0, full, slow, dt)
    # float32 vs float64 through the whole stack, relative to each
    # spectrum's maximum over l <= 2000; with tensors also BB over l <= 700
    # (where the tensor C_l land) and the tensor-only BB
    e = {n: rel_err(cls[F32][i, j, 2:2001], cls[F64][i, j, 2:2001])
         for n, i, j in (("TT", 0, 0), ("TE", 1, 0), ("EE", 1, 1), ("BB", 2, 2),
                         ("PP", 3, 3))}
    if tensor_bb:
        e["BB l<=700"] = rel_err(cls[F32][2, 2, 2:701], cls[F64][2, 2, 2:701])
        e["tensor-only BB"] = rel_err(tensor_bb[F32], tensor_bb[F64])
    log("lensed C_l (l <= 2000) float32 vs float64 at the best fit, max rel "
        "err: " + ", ".join(f"{n} {v:.2e}" for n, v in e.items()))
    require(bool(torch.isfinite(cls[F32]).all()), "finite C_l")
    for n, v in e.items():
        require(v < 1e-2, f"float32 {n} within 1% of float64")
    require(2000.0 < float(cls[F64][0, 0, 220]) < 8000.0, "first peak height")

    # 2. plik_lite fiducial from those C_l
    theory_cl = os.path.join(tmp, f"{label}.theory_cl")
    write_theory_cl(theory_cl, cls[F32])
    ds = write_plik_lite_fiducial(os.path.join(tmp, f"{label}_plik_fid"),
                                  theory_cl)

    # 3. the posterior, float32 (the main path's dtype)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(ds, name="plik_lite", device=dev, dtype=F32))
    post = posterior(likes, F32)
    mll_bf, der_bf = post.logpost()(at_bestfit(post, F32))
    log(f"-logL at the best fit: {float(mll_bf[0]):.6f}")
    require(bool(torch.isfinite(mll_bf).all()), "finite -logL at best fit")
    require(float(mll_bf[0]) < 1.0, "fiducial -logL near 0 at its own point")
    dn = [n for n, _ in post.derived_names]
    log("derived at best fit: " + ", ".join(
        f"{n}={float(der_bf[0, dn.index(n)]):.5g}"
        for n in ("H0", "omegam", "zstar", "rdrag", "age", "yheused")))

    # 4. the sampler: init on 8 chains, one 16-step segment, one slow step
    prop = post.make_proposal(oversample_fast=4)
    w = np.array([p.propose_width for p in post.space.varying])
    prop.set_covariance(np.diag(w ** 2))
    sampler = StagedMetropolisSampler(prop, post, seed=0)
    expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
    rng = np.random.default_rng(0)
    P0 = start_points(post, rng, F32)
    sched = prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                               expensive_blocks=expensive)
    step_classes = sampler.block_class[np.asarray(sched.block)]
    if post.compute_tensors:
        r_block = [i for i, b in enumerate(post.space.speed_blocks())
                   if post.space.varying.index(post.space.get("r")) in b]
        require(post.space.get("r").speed == Speed.SEMISLOW
                and sampler.block_class[r_block[0]] == 1
                and bool((step_classes == 1).any()),
                "r sampled in the semi block, with semi steps in the segment")
    stage_s, calls = instrument_stages(post)

    kernels.reset_launches()
    t0 = time.time()
    state = sampler.init_state(P0)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    t0 = time.time()
    state, out = sampler.run_segment(state, sched)
    torch.cuda.synchronize()
    t_seg = time.time() - t0
    launches = dict(kernels.launches)
    per_segment = {n: launches[n] - at_init[n] for n in launches}
    log("launches in the segment alone: " + json.dumps(per_segment))
    log(f"init {t_init:.2f} s, segment {t_seg:.2f} s "
        f"({SEG_STEPS * NCHAINS / t_seg:.2f} chain steps/s)")
    log("stage wall time: " + ", ".join(
        f"{n} {stage_s[n]:.3f} s / {calls[n]} calls" for n in stage_s))
    log("launches in the main-path run: " + json.dumps(launches))
    mll = state.mloglike
    log("-logL per chain: " + " ".join(f"{float(v):.3f}" for v in mll))
    acc = float(out.accept.float().mean())
    log(f"acceptance {acc:.3f}, step classes {step_classes.tolist()}")
    for n in KERNELS:
        if n in PATH_KERNELS[label]:
            require(launches[n] > 0, f"{n} launched on the {label} path")
        else:
            require(launches[n] == 0, f"{n} not launched on the {label} path")
    require(bool(torch.isfinite(mll).all()), "finite -logL")
    require(bool((mll < 1e29).all()), "no chain stuck at LOG_ZERO")
    require(out.P.shape == (SEG_STEPS, NCHAINS, post.space.num_varying),
            "segment output shape")
    require(bool(torch.isfinite(out.derived).all()), "finite derived")
    require(not bool(out.error.any()), "no error points")
    return launches, per_segment, dict(ds=ds, theory=fid_theory, cls=cls[F64],
                                       post=post)


def leaves(x, path="state"):
    """(path, tensor) for every tensor in a cache: tensors, dicts, tuples,
    NamedTuples and dataclasses of them."""
    if torch.is_tensor(x):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k in x._fields:
            yield from leaves(getattr(x, k), f"{path}.{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{path}.{f.name}")


def flagship_dr12(dev, tmp, fid):
    """Phase 5's synthetic DR12-shaped BAO set, written from the port's
    float64 theory at the best fit (phase 3's `fid["theory"]`); its path
    is also kept as `fid["dr12"]`."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.synthetic import write_dr12_bao
    d = os.path.join(tmp, "dr12")
    bao0 = BAOLikelihood(write_dr12_bao(d), device=dev, dtype=F64)
    fid["dr12"] = write_dr12_bao(
        d, bao0.theory_vector(fid["theory"])[0].cpu().numpy())
    return fid["dr12"]


def drive_runner(dev, tmp, fid):
    """Phase 5: the flagship at phase 3's width with plik_lite + synthetic
    DR12-shaped BAO + the tau prior, under SamplingRun: 8 chains, 4
    segments of 16 steps from the runner's own schedules, burn-in after one
    accept a block, chain files, R-1, and a checkpoint every 2 segments.
    Eight chains are far from converged after a few segments (R-1 ~ 60),
    so the proposal is learned whatever R-1 (max_r_propose_update, the
    reference's MPI_Max_R_ProposeUpdate, is a user setting): the learned
    covariance is then pushed into the staged state and checkpointed.
    A second run resumes from the checkpoint: its state, caches,
    covariance and generator must equal the first run's bit for bit, and
    one more segment on the same schedule must take the same steps in
    both. Returns the launch counts of the run and per segment."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.io.chains import load_chains
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    sync = torch.cuda.synchronize
    dr12 = flagship_dr12(dev, tmp, fid)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(fid["ds"], name="plik_lite", device=dev,
                                 dtype=F32))
    likes.add(BAOLikelihood(dr12, device=dev, dtype=F32))
    par = ThetaParameterization()
    space = par.default_space()
    space.get("tau").prior_mean = 0.0544
    space.get("tau").prior_std = 0.0073
    post = CMBPosterior(par, space, likes, bbn_table=synthetic_bbn_table(),
                        device=dev, dtype=F32)
    at_bf = torch.as_tensor(bestfit_vector(post)[None], dtype=F32, device=dev)
    mll_bf, _ = post.logpost()(at_bf)
    log(f"phase 5: -logL at the best fit (plik_lite + DR12-shaped BAO + tau "
        f"prior) {float(mll_bf[0]):.6f}")
    require(float(mll_bf[0]) < 1.0, "fiducial + BAO -logL near 0 at their point")
    w = np.array([p.propose_width for p in post.space.varying])

    def make_sampler(seed):
        prop = post.make_proposal(oversample_fast=4)
        prop.set_covariance(np.diag(w ** 2))
        return StagedMetropolisSampler(prop, post, seed=seed)

    cfg = RunConfig(nchains=NCHAINS, segment_steps=SEG_STEPS,
                    max_steps=4 * SEG_STEPS, burn_accepts_per_block=1,
                    stats_thin=1, r_stop=0.0, max_r_propose_update=np.inf,
                    checkpoint_freq_segments=2, seed=0)
    P0 = start_points(post, np.random.default_rng(0), F64).cpu().numpy()
    root = os.path.join(tmp, "chains", "flagship")
    s1 = make_sampler(0)
    bare, real_segment = [], s1.run_segment

    def timed_segment(*a, **k):
        sync()
        t0 = time.time()
        out = real_segment(*a, **k)
        sync()
        bare.append(time.time() - t0)
        return out
    s1.run_segment = timed_segment

    sync()
    kernels.reset_launches()
    t0 = time.time()
    run1 = SamplingRun(s1, cfg, P0, chain_root=root, feedback=1,
                       paramnames=post.paramnames(), space=post.space)
    sync()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    res = run1.run()
    sync()
    launches = dict(kernels.launches)
    s1.run_segment = real_segment
    nseg = len(bare)
    per_segment = {n: (launches[n] - at_init[n]) / nseg for n in launches}
    host = res.wall_s - sum(bare)
    log(f"runner: init {t_init:.3f} s; {nseg} segments in {res.wall_s:.3f} s, "
        f"{res.wall_s / nseg:.3f} s a segment under the runner; bare "
        f"run_segment {np.mean(bare):.3f} s a segment (min {min(bare):.3f}, "
        f"max {max(bare):.3f}); host time the runner adds {host:.3f} s, "
        f"{host / nseg:.4f} s a segment ({host / res.wall_s:.1%})")
    log(f"runner: steps {res.steps}, burn-in at {res.burned_in_at}, R-1 "
        f"{res.r_minus_1:.4f}, acceptance {res.accept_rate:.3f}, "
        f"slow/semi/fast steps {run1.class_steps.tolist()}, "
        f"{res.steps * cfg.nchains / res.wall_s:.2f} chain steps/s")
    log("launches in the runner's run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment))
    learned = not np.array_equal(s1.proposal.covariance, np.diag(w ** 2))
    log(f"proposal learned from the chains: {learned}")
    require(learned, "the runner learned the proposal covariance")
    for n in KERNELS:
        if n in PATH_KERNELS["runner"]:
            require(launches[n] > 0, f"{n} launched under the runner")
        else:
            require(launches[n] == 0, f"{n} not launched under the runner")
    mll = run1.state.mloglike
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite -logL under the runner")
    for ext in (".paramnames", ".ranges", ".converge_stat", ".chk.npz"):
        require(os.path.isfile(root + ext), f"runner wrote {ext}")
    require(res.burned_in_at > 0, "burn-in reached")
    chains = load_chains(root, cfg.nchains)
    written = res.steps - res.burned_in_at + cfg.segment_steps
    require(int(chains["weights"].sum()) == written * cfg.nchains,
            "chain weights sum to the written steps x chains")
    require(chains["samples"].shape[1] == post.space.num_varying
            + post.num_derived, "chain file columns")

    check_resume(run1, s1, make_sampler(1), cfg, P0, root)
    return launches, per_segment


def check_resume(run1, s1, s2, cfg, P0, root):
    """A second run with the fresh sampler s2 resumes from run1's
    checkpoint: its state, its caches (rebuilt by state_from_arrays), the
    proposal covariance and the generator must equal run1's bit for bit,
    and one more segment on one schedule must take the same steps in
    both."""
    from cosmomc_tpu_torch.sampling.runner import SamplingRun
    run2 = SamplingRun(s2, cfg, P0, chain_root=root, feedback=0)
    require(run2.resume(), "resume finds the checkpoint")
    run2.writer.close(flush_pending=False)
    a, b = run1.state, run2.state
    for f in ("P", "mloglike", "derived", "num_accept", "mapping"):
        require(torch.equal(getattr(a, f), getattr(b, f)), f"resumed {f}")
    require((run2.steps_done, run2.burned_in_at)
            == (run1.steps_done, run1.burned_in_at), "resumed step counts")
    require(np.array_equal(s2.proposal.covariance, s1.proposal.covariance),
            "resumed proposal covariance")
    require(torch.equal(s2.generator.get_state(), s1.generator.get_state()),
            "resumed generator state")
    carried = dict(leaves((a.slow, a.semi)))
    rebuilt = dict(leaves((b.slow, b.semi)))
    require(carried.keys() == rebuilt.keys(), "rebuilt caches' layout")
    diffs = {k: float((carried[k].double() - rebuilt[k].double()).abs().max())
             if carried[k].numel() else 0.0 for k in carried
             if not torch.equal(carried[k], rebuilt[k])}
    worst = max(diffs.items(), key=lambda kv: kv[1]) if diffs else ("-", 0.0)
    log(f"caches rebuilt by state_from_arrays: {len(carried)} tensors, "
        f"{len(diffs)} differ from the carried ones; largest difference "
        f"{worst[1]:.3e} in {worst[0]}")
    require(not diffs, "rebuilt caches equal the carried ones bit for bit")
    sched = s1.proposal.make_schedule(cfg.segment_steps,
                                      np.random.default_rng(7))
    _, o1 = s1.run_segment(a, sched)
    _, o2 = s2.run_segment(b, sched)
    require(torch.equal(o1.accept, o2.accept) and torch.equal(o1.P, o2.P),
            "the next segment after resume equals the uninterrupted one")
    log("resume: state, caches, covariance and generator restored bit for "
        f"bit; the next segment takes the same {int(o1.accept.sum())} accepts")


def background_sets(dev, tmp):
    """Phase 6's synthetic sets: DR12-shaped BAO, 6dF, a Pantheon-format
    set of BG_NSN SNe with a mag covmat, all written from the port's
    float64 theory at BACKGROUND_TRUTH without scatter, and the HST H0
    that theory gives at zeff = 0.04. Returns their paths and that H0."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.sn import SNLikelihood
    from cosmomc_tpu_torch.models import background as bgm
    from cosmomc_tpu_torch.models.theory import compute_background_theory
    from cosmomc_tpu_torch.params.parameterizations import \
        BackgroundParameterization

    par = BackgroundParameterization()
    full = np.array([p.center for p in par.default_space().params])
    for k, v in sd.BACKGROUND_TRUTH.items():
        full[par.names.index(k)] = v
    th = compute_background_theory(par.to_background(
        torch.as_tensor(full[None], dtype=F64, device=dev)))
    t0 = time.time()
    d = os.path.join(tmp, "background")
    tv = BAOLikelihood(sd.write_dr12_bao(d), device=dev).theory_vector(th)
    dr12 = sd.write_dr12_bao(d, tv[0].cpu().numpy())
    tv = BAOLikelihood(sd.write_6df_bao(d), device=dev).theory_vector(th)
    sixdf = sd.write_6df_bao(d, float(tv[0, 0]))
    cols = sd.pantheon_columns(BG_NSN, seed=0)
    mu = SNLikelihood(sd.write_pantheon(d, cols), device=dev)._mu_model(th)
    sn = sd.write_pantheon(d, cols, mu[0].cpu().numpy() + sd.SN_MB_OFFSET,
                           covmats={"mag": sd.sn_covmat(cols["zcmb"])})
    hst_h0 = float(11425.8 / bgm.angular_diameter_distance(th.bf, 0.04)[0])
    log(f"phase 6: synthetic DR12, 6dF, {BG_NSN} SNe (mag covmat) and HST "
        f"(H0 {hst_h0:.4f}) written at {sd.BACKGROUND_TRUTH} in "
        f"{time.time() - t0:.1f} s")
    return dict(dr12=dr12, sixdf=sixdf, sn=sn, hst_h0=hst_h0)


def drive_background(dev, tmp):
    """Phase 6: bench.py:bench_background's posterior (BackgroundParameterization:
    omegam, H0, ombh2 with its BBN prior; synthetic DR12-shaped BAO, 6dF,
    a Pantheon-format set of BG_NSN SNe with a mag covmat, and HST at the
    truth's H0, all written from the port's float64 theory at
    BACKGROUND_TRUTH without scatter), float32, BG_NCHAINS chains under
    MetropolisSampler and SamplingRun until R-1 < 0.01. Returns the run's
    launch counts and the sets (background_sets). Runs on the CPU too
    (`dev` the CPU device)."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.io.chains import load_chains
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.hst import HSTLikelihood
    from cosmomc_tpu_torch.likelihoods.sn import SNLikelihood
    from cosmomc_tpu_torch.params.parameterizations import \
        BackgroundParameterization
    from cosmomc_tpu_torch.pipeline import BackgroundPosterior
    from cosmomc_tpu_torch.sampling.metropolis import MetropolisSampler
    from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    par = BackgroundParameterization()
    sets = background_sets(dev, tmp)
    dr12, sixdf, sn, hst_h0 = (sets[k] for k in ("dr12", "sixdf", "sn", "hst_h0"))

    def posterior(dtype):
        likes = LikelihoodList()
        likes.add(BAOLikelihood(dr12, device=dev, dtype=dtype))
        likes.add(BAOLikelihood(sixdf, device=dev, dtype=dtype))
        likes.add(SNLikelihood(sn, device=dev, dtype=dtype))
        likes.add(HSTLikelihood(H0=hst_h0, H0_err=1.66))
        return BackgroundPosterior(par, par.default_space(), likes,
                                   device=dev, dtype=dtype)
    post = posterior(F32)
    names = [p.name for p in post.space.varying]
    require(names == ["omegam", "H0", "ombh2"], "background sampled names")
    nchains = BG_NCHAINS
    start = post.start_positions(np.random.default_rng(0), nchains)
    m32 = post.logpost()(torch.as_tensor(start, dtype=F32, device=dev))[0]
    m64 = posterior(F64).logpost()(torch.as_tensor(start, dtype=F64,
                                                   device=dev))[0]
    dm = (m32.double() - m64).abs()
    log(f"background -logL at the {nchains} start points: float32 - float64 "
        f"max {float(dm.max()):.4f}, rms {float(dm.pow(2).mean().sqrt()):.4f} "
        f"(float64 values {float(m64.min()):.2f}..{float(m64.max()):.2f})")
    prop = post.make_proposal()
    prop.set_covariance(np.diag([p.propose_width ** 2
                                 for p in post.space.varying]))
    sampler = MetropolisSampler(prop, post.logpost(),
                                num_derived=post.num_derived, device=dev,
                                dtype=F32)
    cfg = RunConfig(nchains=nchains, segment_steps=BG_SEG_STEPS,
                    max_steps=BG_MAX_STEPS, r_stop=0.01,
                    burn_accepts_per_block=30, stats_thin=1, seed=1)
    root = os.path.join(tmp, "chains", "background")
    sync()
    kernels.reset_launches()
    t0 = time.time()
    run = SamplingRun(sampler, cfg, start, chain_root=root, feedback=0,
                      paramnames=post.paramnames(), space=post.space)
    sync()
    t_init = time.time() - t0
    res = run.run()
    sync()
    launches = dict(kernels.launches)
    log(f"background: {res.stopped_on} at R-1 = {res.r_minus_1:.5f} after "
        f"{res.steps} steps x {nchains} chains; wall-clock to R-1 < 0.01 "
        f"{res.wall_s:.3f} s (init {t_init:.3f} s more); burn-in at "
        f"{res.burned_in_at}; acceptance {res.accept_rate:.3f}; "
        f"{res.steps * nchains / res.wall_s:.1f} chain steps/s")
    require(not any(launches.values()),
            "the background configuration launches no kernel")
    require(res.stopped_on == "converged", "background R-1 < 0.01")
    chains = load_chains(root, nchains)
    written = res.steps - res.burned_in_at + cfg.segment_steps
    require(bool((chains["weights"] >= 1).all())
            and int(chains["weights"].sum()) == written * nchains,
            "background chain weights sum to the written steps x chains")
    require(chains["samples"].shape[1] == 3 + post.num_derived,
            "background chain file columns")
    sig = np.sqrt(np.diag(res.cov))
    for i, name in enumerate(names):
        pull = (res.means[i] - sd.BACKGROUND_TRUTH[name]) / sig[i]
        log(f"  {name}: pooled mean {res.means[i]:.6g} +- {sig[i]:.4g} "
            f"(truth {sd.BACKGROUND_TRUTH[name]}, {pull:+.2f} sigma)")
        if name in ("omegam", "H0"):
            require(abs(pull) < 3.0, f"{name} within 3 sigma of the truth")
    return launches, sets


def drive_matter_power(dev, tmp, fid):
    """Phase 7: the flagship with matter power (CMBPosterior(matter_power=
    True), full width, float32, 8 chains): the slow stage's time with and
    without matter power, sigma8(0) and f sigma8 at 0.38, 0.51, 0.61 at the
    best fit against CAMB (2.5%), then plik_lite + a synthetic DR12 set with
    f_sigma8 rows (written from the port's float64 theory at the best fit)
    + the tau prior under StagedMetropolisSampler: init and one 16-step
    segment with one slow step, which must launch K4 once, K1 twice and K2a
    once a slow step and K3 once a semi step. Returns the launch counts."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.likelihoods.synthetic import write_dr12_bao
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior

    par = ThetaParameterization()
    table = synthetic_bbn_table()
    sync = torch.cuda.synchronize

    def posterior(likes, dtype, matter_power=True):
        space = par.default_space()
        space.get("tau").prior_mean = 0.0544
        space.get("tau").prior_std = 0.0073
        return CMBPosterior(par, space, likes, bbn_table=table, device=dev,
                            dtype=dtype, matter_power=matter_power)

    def at_bestfit(post, dtype, n=1):
        return torch.as_tensor(np.tile(bestfit_vector(post), (n, 1)),
                               dtype=dtype, device=dev)

    # 1. the slow stage with and without matter power, 8 chains, float32
    slow_s, mem = {}, {}
    for on in (False, True):
        post = posterior(LikelihoodList(), F32, on)
        full = post.embed_full(at_bestfit(post, F32, NCHAINS))
        post.stage_slow(full)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        for _ in range(2):
            post.stage_slow(full)
        sync()
        slow_s[on] = (time.time() - t0) / 2
        mem[on] = (torch.cuda.max_memory_allocated() - base) / NCHAINS
    log(f"phase 7: slow stage, {NCHAINS} chains, float32: {slow_s[False]:.3f} s "
        f"a call without matter power, {slow_s[True]:.3f} s with it; peak "
        f"memory a chain {mem[False] / 2**20:.1f} MiB, "
        f"{mem[True] / 2**20:.1f} MiB")

    # 2. sigma8 and f sigma8 at the best fit against CAMB
    s8 = {}
    for dt in (F32, F64):
        post = posterior(LikelihoodList(), dt)
        full = post.embed_full(at_bestfit(post, dt, NCHAINS if dt == F32 else 1))
        slow = post.stage_slow(full)
        theory = post.assemble_theory(slow, post.stage_semi(full, slow))
        require(bool(torch.isfinite(theory.sigma8_z).all()
                     and torch.isfinite(theory.fsigma8_z).all()),
                f"finite sigma8 tables ({str(dt)[6:]})")
        s8[dt] = [float(theory.sigma8_z[0, 0])] + [
            float(theory.fsigma8_at(z)[0]) for z in CAMB_FSIGMA8]
        if dt == F64:
            theory64 = theory
    ref = [CAMB_SIGMA8] + list(CAMB_FSIGMA8.values())
    names = ["sigma8(0)"] + [f"fsigma8({z})" for z in CAMB_FSIGMA8]
    for dt in (F32, F64):
        log(f"  {str(dt)[6:]}: " + ", ".join(
            f"{n} {v:.6f} ({v / r - 1:+.4%} vs CAMB {r})"
            for n, v, r in zip(names, s8[dt], ref)))
    for v, r, n in zip(s8[F32], ref, names):
        require(abs(v / r - 1) < CAMB_TOL, f"float32 {n} within 2.5% of CAMB")
    require(max(abs(a / b - 1) for a, b in zip(s8[F32], s8[F64]))
            < SIGMA8_F32_TOL, "float32 sigma8 and f sigma8 within 0.5% of float64")

    # 3. plik_lite + DR12 with f_sigma8 rows + tau prior, one staged segment
    d = os.path.join(tmp, "dr12_fs8")
    bao0 = BAOLikelihood(write_dr12_bao(d, fsigma8=True), device=dev, dtype=F64)
    ds = write_dr12_bao(d, bao0.theory_vector(theory64)[0].cpu().numpy(),
                        fsigma8=True)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(fid["ds"], name="plik_lite", device=dev,
                                 dtype=F32))
    likes.add(BAOLikelihood(ds, device=dev, dtype=F32))
    post = posterior(likes, F32)
    mll_bf, der_bf = post.logpost()(at_bestfit(post, F32))
    dn = [n for n, _ in post.derived_names]
    mp_names = ["sigma8", "S8", "fsigma8z038", "fsigma8z051", "fsigma8z061"]
    log(f"  -logL at the best fit (plik_lite + DR12 with f_sigma8 + tau "
        f"prior) {float(mll_bf[0]):.6f}; derived " + ", ".join(
            f"{n}={float(der_bf[0, dn.index(n)]):.6f}" for n in mp_names))
    require(float(mll_bf[0]) < 1.0, "fiducial + f_sigma8 BAO -logL near 0")
    launches, per_segment, out = segment_with_matter_power(post, "flagship_mp")
    idx = [dn.index(n) for n in mp_names]
    require(bool(torch.isfinite(out.derived[..., idx]).all()),
            "sigma8, S8 and fsigma8z* finite in the segment's derived values")
    return launches, per_segment


def segment_with_matter_power(post, label, point=None):
    """Init and one 16-step segment with one slow step under
    StagedMetropolisSampler from start points around the best fit (and
    `point`): the run must launch K4 and K2a once, the path's K1
    (PATH_KERNELS[label][1]) twice a slow step and K3 once a semi step,
    nothing else; finite -logL and derived values, no error points.
    Returns the run's launch counts, the segment's and its output."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler
    sync = torch.cuda.synchronize
    prop = post.make_proposal(oversample_fast=4)
    w = np.array([p.propose_width for p in post.space.varying])
    prop.set_covariance(np.diag(w ** 2))
    sampler = StagedMetropolisSampler(prop, post, seed=0)
    expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
    rng = np.random.default_rng(0)
    P0 = start_points(post, rng, F32, point)
    sched = prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                               expensive_blocks=expensive)
    stage_s, calls = instrument_stages(post)
    kernels.reset_launches()
    t0 = time.time()
    state = sampler.init_state(P0)
    sync()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    t0 = time.time()
    state, out = sampler.run_segment(state, sched)
    sync()
    t_seg = time.time() - t0
    launches = dict(kernels.launches)
    per_segment = {n: launches[n] - at_init[n] for n in launches}
    log(f"  init {t_init:.2f} s, segment {t_seg:.2f} s "
        f"({SEG_STEPS * NCHAINS / t_seg:.2f} chain steps/s); stage wall time: "
        + ", ".join(f"{n} {stage_s[n]:.3f} s / {calls[n]} calls" for n in stage_s))
    log("  launches in the main-path run: " + json.dumps(launches)
        + "; in the segment alone: " + json.dumps(per_segment))
    want = {"recfast": calls["slow"], PATH_KERNELS[label][1]: 2 * calls["slow"],
            "los": calls["slow"], "lensing": calls["semi"]}
    for n in KERNELS:
        require(launches[n] == want.get(n, 0),
                f"{n} launched {want.get(n, 0)} times on the {label} path")
    mll = state.mloglike
    log("  -logL per chain: " + " ".join(f"{float(v):.3f}" for v in mll)
        + f"; acceptance {float(out.accept.float().mean()):.3f}")
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            f"finite -logL on the {label} path")
    require(bool(torch.isfinite(out.derived).all()), f"{label}: finite derived")
    require(not bool(out.error.any()), f"{label}: no error points")
    return launches, per_segment, out


def drive_astro(dev, tmp):
    """Phase 8: the astro LSS-only configuration (AstroParameterization,
    CMBPosterior(use_cmb=False, matter_power=True), float32): a synthetic
    LRG DR4-format P(k) set (no Q model), a WiggleZ-format bin at z = 0.6
    with the GiggleZ correction and a DR12 set with f_sigma8 rows, each
    written from the port's float64 theory at the parameterization's
    centres; -logL there is the LRG set's 1/2 ln(P C^-1 P) alone.
    ASTRO_NCHAINS chains under SamplingRun, ASTRO_SEGMENTS segments of 16
    steps, a checkpoint every 2, then a resume that must restore the state
    and the caches (matter transfers and P(k, z) tables included) bit for
    bit. Only K4 and K1 may launch. Returns the launch counts."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.mpk import MPKLikelihood, WiggleZLikelihood
    from cosmomc_tpu_torch.models import background as bgm
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import AstroParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    par = AstroParameterization()
    table = synthetic_bbn_table()
    sync = torch.cuda.synchronize

    def posterior(likes, dtype):
        return CMBPosterior(par, par.default_space(), likes, bbn_table=table,
                            use_cmb=False, matter_power=True, device=dev,
                            dtype=dtype)
    p64 = posterior(LikelihoodList(), F64)
    truth = np.array([p.center for p in p64.space.varying])
    full = p64.embed_full(torch.as_tensor(truth[None], dtype=F64, device=dev))
    slow = p64.stage_slow(full)
    th = p64.assemble_theory(slow, p64.stage_semi(full, slow))
    dv_fid = lambda z: float(th.bg.H0[0] * bgm.bao_d_v(th.bf, z)[0])
    d = os.path.join(tmp, "astro")
    lrg_layout, lrg_keys = sd.lrg_layout(0), dict(DV_fid=dv_fid(sd.LRG_Z),
                                                   Q_marge="F")
    lrg0 = MPKLikelihood(sd.write_lrg_mpk(d, lrg_layout, settings=lrg_keys),
                         device=dev)
    lrg = sd.write_lrg_mpk(d, lrg_layout, sd.mpk_bandpowers(lrg0, th), lrg_keys)
    wz_layout = sd.wigglez_layout(0)
    wz0 = WiggleZLikelihood(sd.write_wigglez(d, wz_layout, 0.6,
                                             DV_fid=dv_fid(0.6)), device=dev)
    wz = sd.write_wigglez(d, wz_layout, 0.6, sd.mpk_bandpowers(wz0, th),
                          dv_fid(0.6))
    bao0 = BAOLikelihood(sd.write_dr12_bao(d, fsigma8=True), device=dev,
                         dtype=F64)
    dr12 = sd.write_dr12_bao(d, bao0.theory_vector(th)[0].cpu().numpy(),
                             fsigma8=True)
    likes = LikelihoodList()
    likes.add(BAOLikelihood(dr12, device=dev, dtype=F32))
    likes.add(MPKLikelihood(lrg, device=dev, dtype=F32))
    likes.add(WiggleZLikelihood(wz, device=dev, dtype=F32))
    post = posterior(likes, F32)
    names = [p.name for p in post.space.varying]
    require(names == ["omegam", "omegab", "H0", "logA", "ns"],
            "astro sampled names")
    lrg_like = likes.likes[1]
    norm = 0.5 * math.log(lrg_like.P_data @ lrg_like.invcov @ lrg_like.P_data)
    mll = float(post.logpost()(torch.as_tensor(truth[None], dtype=F32,
                                               device=dev))[0][0])
    log(f"phase 8: astro -logL at the truth {mll:.6f}; the LRG set's "
        f"1/2 ln(P C^-1 P) {norm:.6f}; sigma8(0) {float(th.sigma8_z[0, 0]):.6f} "
        f"(float64)")
    require(abs(mll - norm) < 1.0, "astro -logL at the truth near its "
            "normalisation alone")

    w = np.array([p.propose_width for p in post.space.varying])

    def make_sampler(seed):
        prop = post.make_proposal()
        prop.set_covariance(np.diag(w ** 2))
        return StagedMetropolisSampler(prop, post, seed=seed)
    cfg = RunConfig(nchains=ASTRO_NCHAINS, segment_steps=SEG_STEPS,
                    max_steps=ASTRO_SEGMENTS * SEG_STEPS,
                    burn_accepts_per_block=1, stats_thin=1, r_stop=0.0,
                    max_r_propose_update=np.inf, checkpoint_freq_segments=2,
                    seed=0)
    lo = np.array([p.min for p in post.space.varying])
    hi = np.array([p.max for p in post.space.varying])
    P0 = np.clip(truth + 0.3 * w * np.random.default_rng(0).standard_normal(
        (ASTRO_NCHAINS, len(w))), lo, hi)
    root = os.path.join(tmp, "chains", "astro")
    s1 = make_sampler(0)
    sync()
    kernels.reset_launches()
    t0 = time.time()
    run1 = SamplingRun(s1, cfg, P0, chain_root=root, feedback=0,
                       paramnames=post.paramnames(), space=post.space)
    sync()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    res = run1.run()
    sync()
    launches = dict(kernels.launches)
    per_segment = {n: (launches[n] - at_init[n]) / ASTRO_SEGMENTS
                   for n in launches}
    log(f"astro: init {t_init:.3f} s; {res.steps} steps x {ASTRO_NCHAINS} "
        f"chains in {res.wall_s:.3f} s ({res.wall_s / ASTRO_SEGMENTS:.3f} s a "
        f"segment, {res.steps * ASTRO_NCHAINS / res.wall_s:.1f} chain steps/s); "
        f"burn-in at {res.burned_in_at}; acceptance {res.accept_rate:.3f}; "
        f"slow/semi/fast steps {run1.class_steps.tolist()}")
    log("launches in the astro run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment))
    for n in KERNELS:
        if n in PATH_KERNELS["astro"]:
            require(launches[n] > 0, f"{n} launched on the astro path")
        else:
            require(launches[n] == 0, f"{n} not launched on the astro path")
    mll = run1.state.mloglike
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite astro -logL")
    require(res.steps == cfg.max_steps, "astro ran its segments")
    check_resume(run1, s1, make_sampler(1), cfg, P0, root)
    return launches, per_segment


def ext_posterior(dev, label, likes, dtype, alpha1=False, **kw):
    """CMBPosterior of phase 9 or 10 at full width: the flagship's
    parameterization with EXT_FREE[label] (and alpha1) freed by ini
    overrides, the tau prior, matter power; `kw` to CMBPosterior."""
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.utils.ini import IniFile
    keys = {f"param[{n}]": v for n, v in EXT_FREE[label].items()}
    if alpha1:
        keys["param[alpha1]"] = ALPHA1_FREE
    par = ThetaParameterization()
    space = par.default_space(IniFile(keys=keys))
    space.get("tau").prior_mean = 0.0544
    space.get("tau").prior_std = 0.0073
    return CMBPosterior(par, space, likes, bbn_table=synthetic_bbn_table(),
                        matter_power=True, device=dev, dtype=dtype, **kw)


def drive_extended(dev, tmp, label):
    """Phases 9 ("mnu": Planck 2018's base_mnu) and 10 ("w0wa": base_w_wa):
    the flagship with EXT_FREE[label] sampled and matter power, full width,
    8 chains, at EXT_POINT[label]: the auto switches (the massive-neutrino
    hierarchy or the DE fluid, alone); C_l float32 against float64 (1%),
    sigma8(z) and f sigma8(z) (0.5%); a plik_lite fiducial written from the
    float32 C_l and a DR12 set with f_sigma8 rows from the float64 theory;
    -logL there with the tau prior; then init and one 16-step segment with
    one slow step under StagedMetropolisSampler, which must launch K4, K2a
    once and the path's K1 instantiation twice a slow step and K3 once a
    semi step, nothing else. Returns the launch counts and the paths of
    the two sets (phase 16's)."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.likelihoods.synthetic import write_dr12_bao

    sync = torch.cuda.synchronize
    point = EXT_POINT[label]
    log(f"phase {label}: " + json.dumps(EXT_FREE[label]) + " at "
        + json.dumps(point))

    def at(post, dtype, n=1):
        return torch.as_tensor(np.tile(bestfit_vector(post, point), (n, 1)),
                               dtype=dtype, device=dev)

    # 1. the theory at the point, float32 (8 chains) and float64 (1 chain)
    theory, cls = {}, {}
    for dt in (F32, F64):
        p0 = ext_posterior(dev, label, LikelihoodList(), dt)
        want = (label == "mnu", label == "w0wa", False)
        require((p0.massive_nu_hierarchy, p0.de_perturbations, p0._iso_enabled)
                == want, f"{label}: the auto switches {want}")
        require(set(EXT_FREE[label]) <= {p.name for p in p0.space.varying},
                f"{label}: {sorted(EXT_FREE[label])} sampled")
        full = p0.embed_full(at(p0, dt, NCHAINS if dt == F32 else 1))
        t0 = time.time()
        slow = p0.stage_slow(full)
        semi = p0.stage_semi(full, slow)
        sync()
        log(f"  theory at the point ({str(dt)[6:]}, {full.shape[0]} chains) "
            f"{time.time() - t0:.2f} s")
        theory[dt], cls[dt] = p0.assemble_theory(slow, semi), semi["cls"][0]
    e = {n: rel_err(cls[F32][i, j, 2:2001], cls[F64][i, j, 2:2001])
         for n, i, j in (("TT", 0, 0), ("TE", 1, 0), ("EE", 1, 1), ("BB", 2, 2),
                         ("PP", 3, 3))}
    s8 = {dt: (theory[dt].sigma8_z[0].double(), theory[dt].fsigma8_z[0].double())
          for dt in (F32, F64)}
    e8 = float((s8[F32][0] / s8[F64][0] - 1).abs().max())
    efs8 = float((s8[F32][1] / s8[F64][1] - 1).abs().max())
    log("  lensed C_l (l <= 2000) float32 vs float64, max rel err: "
        + ", ".join(f"{n} {v:.2e}" for n, v in e.items())
        + f"; sigma8(z) {e8:.3e}, f sigma8(z) {efs8:.3e}; sigma8(0) float32 "
        f"{float(s8[F32][0][0]):.6f}, float64 {float(s8[F64][0][0]):.6f}")
    require(bool(torch.isfinite(cls[F32]).all()), f"{label}: finite C_l")
    for n, v in e.items():
        require(v < 1e-2, f"{label}: float32 {n} within 1% of float64")
    require(2000.0 < float(cls[F64][0, 0, 220]) < 8000.0, f"{label}: first peak")
    require(e8 < SIGMA8_F32_TOL and efs8 < SIGMA8_F32_TOL,
            f"{label}: float32 sigma8 and f sigma8 within 0.5% of float64")

    # 2. the fiducial sets, 3. -logL at the point
    theory_cl = os.path.join(tmp, f"{label}.theory_cl")
    write_theory_cl(theory_cl, cls[F32])
    ds = write_plik_lite_fiducial(os.path.join(tmp, f"{label}_plik_fid"), theory_cl)
    d = os.path.join(tmp, f"{label}_dr12")
    bao0 = BAOLikelihood(write_dr12_bao(d, fsigma8=True), device=dev, dtype=F64)
    dr12 = write_dr12_bao(d, bao0.theory_vector(theory[F64])[0].cpu().numpy(),
                          fsigma8=True)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(ds, name="plik_lite", device=dev, dtype=F32))
    likes.add(BAOLikelihood(dr12, device=dev, dtype=F32))
    post = ext_posterior(dev, label, likes, F32)
    mll_bf, der_bf = post.logpost()(at(post, F32))
    dn = [n for n, _ in post.derived_names]
    log(f"  -logL at the point (plik_lite + DR12 with f_sigma8 + tau prior) "
        f"{float(mll_bf[0]):.6f}; derived " + ", ".join(
            f"{n}={float(der_bf[0, dn.index(n)]):.6f}"
            for n in ("H0", "omeganuh2", "sigma8", "S8", "fsigma8z051")))
    require(float(mll_bf[0]) < 1.0, f"{label}: fiducial -logL near 0 at its point")
    launches, per_segment, _ = segment_with_matter_power(post, label, point)
    return launches, per_segment, dict(ds=ds, dr12=dr12)


def sigma8_mnu_anchors(dev):
    """Phase 9: sigma8(0) and sigma8(3.1) at mnu = 0.07 eV through
    compute_matter_power with the massive-neutrino hierarchy (K1's
    instantiation on the matter grid, 6144 steps, linear), float32 and
    float64, against CAMB_SIGMA8_MNU (1.5%; tests/test_extended_oracle.py,
    whose YHe comes from the BBN table: here the synthetic one)."""
    from cosmomc_tpu_torch.models.background import BackgroundParams
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.matterpower import compute_matter_power
    from cosmomc_tpu_torch.models.primordial import PrimordialParams
    from cosmomc_tpu_torch.models.recfast import compute_thermo
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import mnu_to_omnuh2
    zs = tuple(CAMB_SIGMA8_MNU)
    s8 = {}
    for dt in (F32, F64):
        bg = BackgroundParams.make(ombh2=0.022, omch2=0.122, H0=67.5,
                                   omnuh2=mnu_to_omnuh2(0.07), device=dev, dtype=dt)
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, dt))
        th = compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, torch.full((1,), 0.06, dtype=dt, device=dev), yhe)
        one = bg.H0.new_ones(1)
        pp = PrimordialParams.make(logA=one * math.log(2e-9 * 1e10), ns=one * 0.965)
        mp = compute_matter_power(bg, pp, th, zre, yhe, z_outputs=zs,
                                  nonlinear=False, massive_nu=True)
        s8[dt] = [float(v) for v in mp.sigma8_z[0]]
    for dt in (F32, F64):
        log(f"  sigma8 at mnu = 0.07 eV ({str(dt)[6:]}): " + ", ".join(
            f"z={z}: {v:.6f} ({v / r - 1:+.4%} vs CAMB {r})"
            for z, v, r in zip(zs, s8[dt], CAMB_SIGMA8_MNU.values())))
    for z, v, r in zip(zs, s8[F32], CAMB_SIGMA8_MNU.values()):
        require(abs(v / r - 1) < CAMB_MNU_TOL,
                f"float32 sigma8({z}) at mnu = 0.07 eV within 1.5% of CAMB")
    return s8


def iso_response(dev):
    """Phase 10: the base_w_wa posterior with alpha1 also free, float64, at
    EXT_POINT["w0wa"] and alpha1 giving the admixture amplitudes 0, ISO_B,
    -ISO_B, 2 ISO_B (one chain each) through the slow and semi stages (the
    DE-fluid instantiation with isocurvature ICs): the unlensed TT is
    quadratic in the amplitude, C(2b) = C(0) + 2 (C(b) - C(-b)) / 2 + 4
    ((C(b) + C(-b)) / 2 - C(0)) (tests/test_isocurvature.py, rtol 5e-4,
    atol 1e-6 muK^2), and the pure-isocurvature part is >= 0."""
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.models.cls import cls_from_cl_transfers
    post = ext_posterior(dev, "w0wa", LikelihoodList(), F64, alpha1=True)
    require(post._iso_enabled and post.de_perturbations
            and not post.massive_nu_hierarchy, "w0wa + alpha1: the switches")
    amp = np.array([0.0, ISO_B, -ISO_B, 2 * ISO_B])
    P = np.tile(bestfit_vector(post, EXT_POINT["w0wa"]), (4, 1))
    P[:, [p.name for p in post.space.varying].index("alpha1")] = \
        np.sign(amp) * amp ** 2 / (1 + amp ** 2)
    full = post.embed_full(torch.as_tensor(P, dtype=F64, device=dev))
    got = post.iso_amplitude(full)
    require(float((got.cpu() - torch.as_tensor(amp)).abs().max()) < 1e-12,
            "alpha1 -> amplitude map")
    slow = post.stage_slow(full)
    semi = post.stage_semi(full, slow)
    raw = cls_from_cl_transfers(slow["clt"], post._primordial(full),
                                lmax=post.lmax + post.lens_margin)
    tt = (raw.tt * MUK2).cpu().numpy()
    t0, tp, tm, t2 = tt
    iso_b2 = 0.5 * (tp + tm) - t0
    pred = t0 + (tp - tm) + 4.0 * iso_b2
    excess = np.abs(t2 - pred) / (ISO_ATOL + ISO_RTOL * np.abs(pred))
    log(f"  isocurvature at amplitudes {amp.tolist()}: unlensed TT, l <= "
        f"{post.lmax + post.lens_margin}: |C(2b) - quadratic| at most "
        f"{float(np.abs(t2 - pred).max()):.3e} muK^2, {float(excess.max()):.3e} of "
        f"the tolerance; pure-iso TT at l=10 {float(iso_b2[8]):.4f}, l=150 "
        f"{float(iso_b2[148]):.4f} muK^2 (b = {ISO_B})")
    require(bool(np.isfinite(tt).all()) and bool(torch.isfinite(semi["cls"]).all()),
            "isocurvature C_l finite")
    require(bool((iso_b2 > -1e-8 * np.abs(t0)).all()), "pure-iso TT >= 0")
    require(float(excess.max()) <= 1.0, "isocurvature TT quadratic in the amplitude")
    return float(np.abs(t2 - pred).max())


def check_sync(fn):
    """Whether `fn` waits for the card: a ~50 ms sleep kernel is queued
    first, and a call that returns after it has run synchronised. Returns
    (synchronised, the call's host ms, the sync-debug warnings it raised,
    the source lines that raised them)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.time()
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_ms = 1e3 * (time.time() - t0)
    torch.cuda.synchronize()
    stall = torch.cuda.Event(enable_timing=True)
    sleep = torch.cuda.Event(enable_timing=True)
    sleep.record()
    torch.cuda._sleep(int(1e8))
    stall.record()
    torch.cuda.synchronize()
    sleep_ms = sleep.elapsed_time(stall)
    sites = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return host_ms > 0.8 * sleep_ms, host_ms, len(sites), sorted(set(sites))


def drive_spt(dev, tmp, fid):
    """Phase 11: the SPT configuration on the flagship (theta LCDM, halofit
    lensing, table LOS, full width). SPTpol TE/EE (56 bins a spectrum to l
    = 8000), SPTpol BB (150x150, 95x150, 95x95) and an SPT-SZ-shaped TT set
    (47 Gaussian bandpowers, calibration, aberration) raise lmax to 8001;
    lmax_computed = 2508 and a template written from phase 3's float64
    lensed spectrum by write_highl_template fills above. The sets are
    written from the port's float64 theory at the best fit (the splice
    included), without scatter. Checks: the LOS (K2a) at 2508 + 150 and at
    the flagship's shape, lensing (K3) 2507 l wide; the float32 C_l above
    2508 equal to TT(2508) / template TT(2508) times the template (float32
    rounding), phi-phi 0 there; float32 C_l within 1% of float64 to l =
    2000; -logL at the best fit equal to its constant in float64 and within
    SPT_F32_TOL of it in float32; SPT_SEGMENTS staged 16-step segments,
    each slow step launching K4, K1, K2a once and each semi step K3 once;
    BK-Planck (a BK15-shaped set) and CMBLikes in HL and fullsky-exact
    mode on the cached float32 and float64 theory, finite and within
    SPT_F32_TOL. Returns the launch counts of the run and per segment."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch import pipeline as pl
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.bkplanck import BKPlanckLikelihood
    from cosmomc_tpu_torch.likelihoods.cmblikes import CMBLikes
    from cosmomc_tpu_torch.likelihoods.sptpol import (SPTpolBBLikelihood,
                                                      SPTpolTEEELikelihood)
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    sync = torch.cuda.synchronize
    path = lambda name: os.path.join(tmp, "spt", name)
    par = ThetaParameterization()
    table = synthetic_bbn_table()
    os.makedirs(path(""), exist_ok=True)
    tmpl = sd.write_highl_template(path("HighL_lensedCls_synthetic.dat"),
                                   fid["cls"].double().cpu().numpy(), SPT_LMAX)

    def posterior(likes, dtype):
        space = par.default_space()
        space.get("tau").prior_mean = 0.0544
        space.get("tau").prior_std = 0.0073
        return pl.CMBPosterior(par, space, likes, bbn_table=table, device=dev,
                               dtype=dtype, lmax_computed=SPT_LMAX_COMPUTED,
                               highl_template=tmpl)

    def at(post, dtype, n=1):
        return torch.as_tensor(np.tile(bestfit_vector(post), (n, 1)),
                               dtype=dtype, device=dev)

    def readers(sets):
        return [SPTpolTEEELikelihood(sets[0], device=dev),
                SPTpolBBLikelihood(sets[1], device=dev),
                CMBLikes(sets[2], name="sptsz_synthetic", device=dev)]

    def likelihood_list(likes):
        out = LikelihoodList()
        for like in likes:
            out.add(like)
        return out

    # 1. the float64 theory at the best fit on the sets' layouts
    layout = readers([sd.write_sptpol_teee(path("teee0")),
                      sd.write_sptpol_bb(path("bb0")),
                      sd.write_cmblikes_tt(path("tt0"))])
    post64 = posterior(likelihood_list(layout), F64)
    require((post64.lmax, post64.lmax_computed) == (SPT_LMAX, SPT_LMAX_COMPUTED),
            "the likelihoods raise lmax to 8001 over lmax_computed 2508")
    full = post64.embed_full(at(post64, F64))
    slow64 = post64.stage_slow(full)
    semi64 = post64.stage_semi(full, slow64)
    theory64 = post64.assemble_theory(slow64, semi64)

    # 2. the sets written there
    sets = [sd.write_sptpol_teee(path("teee"),
                                 sd.sptpol_bandpowers(layout[0], theory64)),
            sd.write_sptpol_bb(path("bb"), sd.sptpol_bandpowers(layout[1],
                                                                theory64)),
            sd.write_cmblikes_tt(path("tt"), sd.cmblikes_bandpowers(
                layout[2], semi64["cls"])[:, 0])]
    likes = readers(sets)
    post = posterior(likelihood_list(likes), F32)
    post64 = posterior(likelihood_list(readers(sets)), F64)

    # 3. the float32 theory (8 chains at the best fit), with the LOS and
    # lensing calls' multipoles recorded
    seen = {"los": [], "lens": [], "lensed": []}
    real_los, real_lens = pl.compute_cl_transfers, pl.lens_cls

    def los(*a, **k):
        seen["los"].append(k["lmax"])
        return real_los(*a, **k)

    def lens(*a, **k):
        seen["lens"].append(k["lmax_lensed"])
        out = real_lens(*a, **k)
        seen["lensed"].append(out.tt.shape[-1])
        return out
    pl.compute_cl_transfers, pl.lens_cls = los, lens
    try:
        full32 = post.embed_full(at(post, F32, NCHAINS))
        t0 = time.time()
        slow32 = post.stage_slow(full32)
        semi32 = post.stage_semi(full32, slow32)
        sync()
        log(f"phase 11: theory at the best fit (float32, {NCHAINS} chains) "
            f"{time.time() - t0:.2f} s; lmax {post.lmax}, lmax_computed "
            f"{post.lmax_computed}")
        clt = slow32["clt"]
        log(f"  K2a: l {int(clt.ls.min())}..{int(clt.ls.max())}, "
            f"{tuple(clt.dT.shape[1:])} (sampled l, fine k); K3 lensed width "
            f"{seen['lensed'][-1]}")
        require(int(clt.ls.max()) == SPT_LMAX_COMPUTED + post.lens_margin
                and tuple(clt.dT.shape[1:]) == FLAGSHIP_K2A_SHAPE,
                "K2a at the flagship's shape (l to 2508 + 150)")
        require(seen["lensed"][-1] == FLAGSHIP_LENSED_L,
                "K3's lensed output 2507 l wide")
        cls32, cls64 = semi32["cls"], semi64["cls"][0]
        require(cls32.shape == (NCHAINS, 4, 4, SPT_LMAX + 1), "C_l to 8001")
        lm, hi = SPT_LMAX_COMPUTED, slice(SPT_LMAX_COMPUTED + 1, SPT_LMAX + 1)
        t64 = post64._highl
        norm = cls32[:, 0, 0, lm].double() / t64[lm, 0]
        errs = {}
        for n, (i, j), col in (("TT", (0, 0), 0), ("EE", (1, 1), 1),
                               ("BB", (2, 2), 2), ("TE", (1, 0), 3)):
            want = norm[:, None] * t64[hi, col]
            errs[n] = rel_err(cls32[:, i, j, hi], want)
        log("  splice above 2508, float32 C_l against norm x template, max err "
            "relative to each spectrum's maximum there: " + ", ".join(
                f"{n} {v:.2e}" for n, v in errs.items())
            + f"; norm {float(norm[0]):.6f}")
        for n, v in errs.items():
            require(v < SPLICE_RTOL, f"spliced {n} = norm x template")
        require(not bool(cls32[:, 3, 3, hi].any()), "phi-phi 0 above 2508")
        e = {n: rel_err(cls32[0, i, j, 2:2001], cls64[i, j, 2:2001])
             for n, i, j in (("TT", 0, 0), ("TE", 1, 0), ("EE", 1, 1),
                             ("BB", 2, 2), ("PP", 3, 3))}
        e["TT above 2508"] = rel_err(cls32[0, 0, 0, hi], cls64[0, 0, hi])
        log("  C_l float32 vs float64, max rel err: "
            + ", ".join(f"{n} {v:.2e}" for n, v in e.items()))
        for n, v in e.items():
            require(v < 1e-2, f"phase 11 float32 {n} within 1% of float64")
        require(bool(torch.isfinite(cls32).all()), "finite spliced C_l")

        # 4. -logL at the best fit, float32 and float64, against its
        # constant: the SPTpol sets' half ln det Cov, the tau prior
        tau = BESTFIT["tau"]
        const = (likes[0].half_logdet + likes[1].half_logdet
                 + 0.5 * ((tau - 0.0544) / 0.0073) ** 2)
        m32 = float(post.logpost()(at(post, F32))[0][0])
        m64 = float(post64.logpost()(at(post64, F64))[0][0])
        log(f"  -logL at the best fit: float32 {m32:.6f}, float64 {m64:.9f}, "
            f"constant {const:.9f} (half ln det Cov: TE/EE "
            f"{likes[0].half_logdet:.6f}, BB {likes[1].half_logdet:.6f}); "
            f"float32 - float64 {m32 - m64:.3e}")
        require(abs(m64 - const) < 1e-6, "float64 -logL at its constant")
        require(abs(m32 - m64) < SPT_F32_TOL, "float32 -logL near float64's")
        require(abs(const) > 1.0, "the constant is not 0")

        # 5. the staged sampler: SPT_SEGMENTS segments, one slow step each
        prop = post.make_proposal(oversample_fast=4)
        w = np.array([p.propose_width for p in post.space.varying])
        prop.set_covariance(np.diag(w ** 2))
        sampler = StagedMetropolisSampler(prop, post, seed=0)
        expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
        rng = np.random.default_rng(0)
        P0 = start_points(post, rng, F32)
        stage_fast = post.stage_fast
        stage_s, calls = instrument_stages(post)
        kernels.reset_launches()
        seen["los"].clear()
        seen["lens"].clear()
        t0 = time.time()
        state = sampler.init_state(P0)
        sync()
        t_init = time.time() - t0
        at_init, calls_init = dict(kernels.launches), dict(calls)
        seg_s, out = [], None
        for _ in range(SPT_SEGMENTS):
            sched = prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                                       expensive_blocks=expensive)
            t0 = time.time()
            state, out = sampler.run_segment(state, sched)
            sync()
            seg_s.append(time.time() - t0)
        launches = dict(kernels.launches)
        per_segment = {n: (launches[n] - at_init[n]) / SPT_SEGMENTS
                       for n in launches}
        run_calls = {n: calls[n] - calls_init[n] for n in calls}
    finally:
        pl.compute_cl_transfers, pl.lens_cls = real_los, real_lens
    steps = SPT_SEGMENTS * SEG_STEPS * NCHAINS
    log(f"  init {t_init:.2f} s; {SPT_SEGMENTS} segments {sum(seg_s):.2f} s "
        f"({', '.join(f'{v:.3f}' for v in seg_s)}), {steps / sum(seg_s):.2f} "
        "chain steps/s; stage wall per call: " + ", ".join(
            f"{n} {1e3 * stage_s[n] / max(calls[n], 1):.1f} ms "
            f"({calls[n]} calls)" for n in stage_s))
    log("  launches in the run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment)
        + f"; stage calls in the segments: {json.dumps(run_calls)}")
    want = {"recfast": calls["slow"], "boltzmann": calls["slow"],
            "los": calls["slow"], "lensing": calls["semi"]}
    for n in KERNELS:
        require(launches[n] == want.get(n, 0),
                f"{n} launched {want.get(n, 0)} times on the spt path")
    require(set(seen["los"]) == {SPT_LMAX_COMPUTED + post.lens_margin}
            and set(seen["lens"]) == {SPT_LMAX_COMPUTED},
            "the LOS and lensing stay at lmax_computed in every call")
    mll = state.mloglike
    log("  -logL per chain: " + " ".join(f"{float(v):.3f}" for v in mll)
        + f"; acceptance {float(out.accept.float().mean()):.3f}")
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite -logL on the spt path")
    require(bool(torch.isfinite(out.derived).all()), "spt: finite derived")
    require(not bool(out.error.any()), "spt: no error points")
    s_fast = check_sync(lambda: stage_fast(state.P, state.slow, state.semi))
    log(f"  fast stage (SPTpol x2 + SPT-SZ TT, {NCHAINS} chains): waits for "
        f"the card {s_fast[0]} (host {s_fast[1]:.1f} ms, sync warnings "
        f"{s_fast[2]} at {', '.join(s_fast[3])})")

    # 6. BK-Planck and CMBLikes HL / fullsky exact on the cached theory
    th32 = post.assemble_theory(slow32, semi32)
    bk0 = BKPlanckLikelihood(sd.write_bk_like(path("bk0")), device=dev)
    other = {
        "BK-Planck (HL, 3 B maps)": BKPlanckLikelihood(sd.write_bk_like(
            path("bk"), sd.cmblikes_bandpowers(bk0, semi64["cls"])), device=dev)}
    for approx, kw in (("HL", {}), ("exact", dict(lrange=(2, 200)))):
        l0 = CMBLikes(sd.write_cmblikes_tt(path(f"tt_{approx}0"),
                                           like_approx=approx, **kw),
                      device=dev)
        vals = sd.cmblikes_bandpowers(l0, semi64["cls"])[:, 0]
        other[f"CMBLikes {approx} (TT)"] = CMBLikes(sd.write_cmblikes_tt(
            path(f"tt_{approx}"), vals, like_approx=approx, **kw), device=dev)
    for name, like in other.items():
        nu = torch.as_tensor([[p.center for p in like.nuisance if p.varying]]
                             * NCHAINS, dtype=F64, device=dev)
        v64 = like.log_like(theory64, nu[:1])
        like.log_like(th32, nu)
        ms, v32 = timed(lambda: like.log_like(th32, nu), reps=5)
        synced, host_ms, n_sync, sites = check_sync(
            lambda: like.log_like(th32, nu))
        d = float((v32.double() - v64).abs().max())
        log(f"  {name}: -logL float64 theory {float(v64[0]):.6e}, float32 "
            f"theory {float(v32[0]):.6e} (max |diff| {d:.3e}), {ms:.3f} ms a "
            f"call ({NCHAINS} chains); waits for the card {synced} (host "
            f"{host_ms:.1f} ms, sync warnings {n_sync} at {', '.join(sites)})")
        require(bool(torch.isfinite(v32).all()) and bool(torch.isfinite(v64).all()),
                f"{name}: finite")
        require(d < SPT_F32_TOL, f"{name}: float32 theory within "
                f"{SPT_F32_TOL} of float64")
    return launches, per_segment


def sz_cash_by_hand(counts, DN):
    """The Cash -logL of theory counts DN (nz, nq) against a catalogue
    written from integer `counts` plus synthetic.SZ_MISSING_Q rows with no
    redshift, recomputed from the counts in numpy: each missing row scales
    its S/N column so the column total grows by one, then Stirling's
    ln n! above 10 and the exact one below (szcounts.f90:1769-1944)."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods import szcounts as sz
    ny = counts.shape[1] - 1
    lc = sz.LOGY_MIN + (np.arange(ny + 1) + 0.5) * sz.DLOGY
    qlo, qhi = 10.0 ** (lc - 0.5 * sz.DLOGY), 10.0 ** (lc + 0.5 * sz.DLOGY)
    n = counts.astype(float)
    for q in sd.SZ_MISSING_Q:
        j = ny if q >= qhi[ny - 1] else int(np.nonzero((qlo <= q) & (q < qhi))[0][0])
        if n[:, j].sum() > 0:
            n[:, j] *= (n[:, j].sum() + 1.0) / n[:, j].sum()
    lnf = np.array([0.0 if v == 0 else
                    (0.918939 + (v + 0.5) * math.log(v) - v if v > 10
                     else math.lgamma(math.floor(v) + 1.0))
                    for v in n.ravel()]).reshape(n.shape)
    term = np.where(DN > 0, n * np.log(np.maximum(DN, 1e-300)) - DN - lnf, 0.0)
    return -float(term.sum())


def abundance_by_hand(tab, ds, ombh2, dn):
    """An abundance set's Gaussian at (ombh2, DeltaN) from the numbers in
    its .dataset and a bilinear lookup in the BBN grids (numpy)."""
    keys = {}
    with open(ds) as f:
        for line in f:
            k, _, v = line.partition("=")
            keys[k.strip()] = v.strip()
    x = (ombh2 - tab.ombh2_0) / tab.ombh2_step
    y = (dn - tab.dn_0) / tab.dn_step
    i, j = int(x), int(y)
    fx, fy = x - i, y - j

    def at(g):
        g = np.asarray(g)
        return ((1 - fx) * (1 - fy) * g[i, j] + fx * (1 - fy) * g[i + 1, j]
                + (1 - fx) * fy * g[i, j + 1] + fx * fy * g[i + 1, j + 1])
    dh = keys["measurement"] == "D/H"
    pred = at(tab.dh if dh else tab.ypbbn)
    terr = float(keys.get("theory_effective_error", 0.0)) or at(
        tab.sig_dh if dh else tab.sig_yp)
    t = pred + float(keys.get("theory_bias_offset", 0.0)) - float(keys["mean"])
    return 0.5 * t * t / (float(keys["error"]) ** 2 + terr ** 2)


def lss_bbn_sets(dev, tmp):
    """Phase 12's sets, written before phase 3 (phase 14's CPU gradient
    reads them from a process of its own while the card runs phases 2-13):
    a DES 1YR-shaped 3x2pt set, a Planck 2015-shaped SZ set, D/H and Yp
    abundances on a written BBN grid and the synthetic DR12 BAO set with
    f_sigma8 rows, each written from the port's float64 theory at the
    centres. Returns their paths and what phase 12 checks them with."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.szcounts import SZCountsLikelihood
    from cosmomc_tpu_torch.likelihoods.wl import WLLikelihood
    from cosmomc_tpu_torch.models.bbn import load_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import AstroParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior

    d = os.path.join(tmp, "lss_bbn")
    par = AstroParameterization()
    table_path = sd.write_bbn_table(os.path.join(d, sd.BBN_TABLE_NAME))
    table = load_bbn_table(table_path)
    abund = [sd.write_abundance(d, n, **sd.ABUNDANCE_SETS[n])
             for n in ("D_Cooke2017", "Yp_Aver2015")]
    des = sd.write_des_wl(d)
    sd.write_sz_selection(d)
    sd.write_sz_catalogue(d, np.zeros((11, 5), int))
    bao0 = BAOLikelihood(sd.write_dr12_bao(d, fsigma8=True), device=dev)

    def posterior(likes, dtype):
        return CMBPosterior(par, par.default_space(), likes, bbn_table=table,
                            use_cmb=False, matter_power=True, device=dev,
                            dtype=dtype)

    def centres(post, dtype, n=1):
        v = np.array([p.center for p in post.space.varying])
        return torch.as_tensor(np.tile(v, (n, 1)), dtype=dtype, device=dev)

    # 1. the float64 theory at the centres, on the full likelihoods' grids
    wl_all = WLLikelihood(des, dataset_overrides={
        "data_selection": "DES_1YR_synthetic" + sd.DES_ALL_SCALES}, device=dev)
    sz0 = SZCountsLikelihood(d, device=dev)
    req = LikelihoodList()
    req.add(wl_all)
    req.add(sz0)
    p64 = posterior(req, F64)
    full = p64.embed_full(centres(p64, F64))
    slow = p64.stage_slow(full)
    th64 = p64.assemble_theory(slow, p64.stage_semi(full, slow))
    log(f"phase 12: z_pk {len(p64.z_pk)} redshifts to {max(p64.z_pk):.4f} "
        f"(WL required_zmax {wl_all.required_zmax:.4f}, SZ 1.2); "
        f"sigma8(0) {float(th64.sigma8_z[0, 0]):.6f} (float64)")

    # 2. the sets, written from that theory
    des = sd.write_des_wl(d, sd.des_wl_rows(wl_all, th64))
    nu_sz = sz0.nuisance_values(torch.as_tensor(
        [[p.center for p in sz0.nuisance if p.varying]], dtype=F64, device=dev))
    counts = np.rint(sz0.theory_counts(th64, nu_sz)[0].cpu().numpy()).astype(int)
    sd.write_sz_catalogue(d, counts)
    dr12 = sd.write_dr12_bao(d, bao0.theory_vector(th64)[0].cpu().numpy(),
                             fsigma8=True)
    return dict(d=d, par=par, table=table, table_path=table_path, abund=abund,
                des=des, dr12=dr12, counts=counts, nu_sz=nu_sz, th64=th64,
                posterior=posterior, centres=centres)


def lss_bbn_likes(dev, sets, nonlinear=True):
    """Phase 12's likelihood list on `sets` (`lss_bbn_sets`): WL (on the
    halofit P(k) unless not `nonlinear`), SZ, the two abundances and DR12
    with f_sigma8 rows."""
    from cosmomc_tpu_torch.likelihoods.abundances import AbundanceLikelihood
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.szcounts import SZCountsLikelihood
    from cosmomc_tpu_torch.likelihoods.wl import WLLikelihood
    likes = LikelihoodList()
    likes.add(WLLikelihood(sets["des"], use_non_linear=nonlinear, device=dev))
    likes.add(SZCountsLikelihood(sets["d"], device=dev))
    for ds in sets["abund"]:
        likes.add(AbundanceLikelihood(ds, device=dev))
    likes.add(BAOLikelihood(sets["dr12"], device=dev, dtype=F64))
    return likes


def drive_lss_bbn(dev, tmp, sets):
    """Phase 12, part 1: the LSS-only configuration with a BBN prior as
    cosmomc_tpu/driver.py builds it (parameterization = astro:
    AstroParameterization and CMBPosterior(use_cmb=False,
    matter_power=True), use_WL, use_SZ, abundance datasets): a DES 1YR-shaped 3x2pt set, a Planck 2015-shaped
    SZ set (dN/dz/dq, Tinker), D/H and Yp abundances on a written BBN grid
    and the synthetic DR12 BAO set with f_sigma8 rows, each written from
    the port's float64 theory at the centres. The matter grid at full
    width (216 k to 8/Mpc, 6144 steps), z_pk extended by WL's
    required_zmax and SZ's 1.2, the theory in float32, the likelihoods in
    float64. At the centres in float64: WL's chi^2/2 is 0, each abundance
    its Gaussian by hand, SZ's Cash sum recomputed in numpy, the
    per-likelihood table summing to the fast stage's total; the float32
    theory within LSS_F32_TOL of each. Then StagedMetropolisSampler on
    LSS_NCHAINS chains: init, LSS_SEGMENTS segments of SEG_STEPS with one
    slow step each, launching K4 and K1 once a slow step and nothing
    else; each new likelihood's ms a call and whether it waits for the
    card. Returns the launch counts."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    t_phase = time.time()
    table, abund, counts = sets["table"], sets["abund"], sets["counts"]
    nu_sz, th64, posterior = sets["nu_sz"], sets["th64"], sets["posterior"]
    centres = sets["centres"]
    likes = lss_bbn_likes(dev, sets)
    wl, sz = likes.likes[0], likes.likes[1]
    log(f"  DES: {wl.num_used} of {sd.N_DES_ROWS} rows after the cuts; SZ: "
        f"{sz.ncat} clusters at q >= 6 ({sz.nmiss} without a redshift), "
        f"{len(sz.skyfracs)} patches x {len(sz.thetas)} theta, f_sky "
        f"{sz.fsky:.3f}")
    require(400 <= wl.num_used <= 500, "DES cuts keep about half the rows")
    require(150 <= int(counts.sum()) <= 1000, "a few hundred SZ clusters")

    # 3. at the centres, float64 and float32 theory
    post64, post32 = posterior(likes, F64), posterior(likes, F32)
    truth = np.array([p.center for p in post64.space.varying])
    per64 = post64.per_likelihood(truth)
    per32 = post32.per_likelihood(truth)
    log("  -logL per likelihood at the centres, float64 theory / float32 "
        "theory: " + ", ".join(f"{n} {per64[n]:.9f} / {per32[n]:.9f}"
                               for n in per64))
    full = post64.embed_full(centres(post64, F64))
    slow64 = post64.stage_slow(full)
    semi64 = post64.stage_semi(full, slow64)
    total, _ = post64.stage_fast(centres(post64, F64), slow64, semi64)
    require(abs(sum(per64.values()) - float(total[0]))
            <= 1e-9 * max(1.0, abs(float(total[0]))),
            "per_likelihood sums to the fast stage's total")
    require(abs(per64[wl.name]) < LSS_WL_ZERO, "WL chi^2/2 = 0 at its theory")
    bg = th64.bg
    for ds, like in zip(abund, likes.likes[2:4]):
        want = abundance_by_hand(table, ds, float(bg.ombh2[0]),
                                 float(bg.nnu[0]) - 3.046)
        require(abs(per64[like.name] - want) <= LSS_HAND_RTOL * abs(want),
                f"{like.name} equals its Gaussian by hand ({want:.12e})")
    DN = sz.theory_counts(th64, nu_sz)[0].cpu().numpy()
    want = sz_cash_by_hand(counts, DN)
    require(abs(per64[sz.name] - want) <= LSS_HAND_RTOL * abs(want),
            f"SZ Cash -logL equals the sum from its counts ({want:.9f})")
    for n in per64:
        require(abs(per32[n] - per64[n]) < LSS_F32_TOL,
                f"{n}: float32 theory within {LSS_F32_TOL} of float64")

    # 4. the staged sampler, float32 theory
    prop = post32.make_proposal()
    w = np.array([p.propose_width for p in post32.space.varying])
    prop.set_covariance(np.diag(w ** 2))
    sampler = StagedMetropolisSampler(prop, post32, seed=0)
    expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
    rng = np.random.default_rng(0)
    lo = np.array([p.min for p in post32.space.varying])
    hi = np.array([p.max for p in post32.space.varying])
    P0 = torch.as_tensor(np.clip(truth + 0.3 * w * rng.standard_normal(
        (LSS_NCHAINS, len(w))), lo, hi), dtype=F32, device=dev)
    scheds = [prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                                 expensive_blocks=expensive)
              for _ in range(LSS_SEGMENTS)]
    stage_s, calls = instrument_stages(post32)
    torch.cuda.synchronize()
    kernels.reset_launches()
    state = sampler.init_state(P0)
    torch.cuda.synchronize()
    at_init = dict(kernels.launches)
    t0 = time.time()
    for sched in scheds:
        state, out = sampler.run_segment(state, sched)
    torch.cuda.synchronize()
    t_run = time.time() - t0
    launches = dict(kernels.launches)
    per_segment = {n: (launches[n] - at_init[n]) / LSS_SEGMENTS
                   for n in launches}
    log(f"  {LSS_SEGMENTS} segments x {SEG_STEPS} steps x {LSS_NCHAINS} chains "
        f"in {t_run:.3f} s ({LSS_SEGMENTS * SEG_STEPS * LSS_NCHAINS / t_run:.1f} "
        f"chain steps/s); stage wall time: " + ", ".join(
            f"{n} {stage_s[n]:.3f} s / {calls[n]} calls" for n in stage_s))
    log("  launches in the lss_bbn run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment))
    for n in KERNELS:
        want = 1 if n in PATH_KERNELS["lss_bbn"] else 0
        require(at_init[n] == want and per_segment[n] == want,
                f"{n} launched {want} time(s) at init and a segment on the "
                f"lss_bbn path")
    mll = state.mloglike
    log("  -logL per chain: " + " ".join(f"{float(v):.2f}" for v in mll)
        + f"; acceptance {float(out.accept.float().mean()):.3f}")
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite -logL on the lss_bbn path")
    require(bool(torch.isfinite(out.derived).all()), "lss_bbn: finite derived")
    require(not bool(out.error.any()), "lss_bbn: no error points")

    # 5. the fast stage and each new likelihood: ms a call, host waits
    stage_fast = type(post32).stage_fast.__get__(post32)
    fast = lambda: stage_fast(state.P, state.slow, state.semi)
    fast_ms, _ = timed(fast, reps=3)
    s_fast = check_sync(fast)
    log(f"  fast stage ({LSS_NCHAINS} chains): {fast_ms:.3f} ms a call; "
        f"waits for the card {s_fast[0]} (host {s_fast[1]:.1f} ms, sync "
        f"warnings {s_fast[2]} at {', '.join(s_fast[3])})")
    th32 = post32.assemble_theory(state.slow, state.semi)
    for like in likes.likes[:4]:
        cols = post32.slices[like.name]
        nu = state.P[:, cols]
        like.log_like(th32, nu)
        ms, _ = timed(lambda: like.log_like(th32, nu), reps=3)
        synced, host_ms, n_sync, sites = check_sync(
            lambda: like.log_like(th32, nu))
        log(f"  {like.name}: {ms:.3f} ms a call ({LSS_NCHAINS} chains); waits "
            f"for the card {synced} (host {host_ms:.1f} ms, sync warnings "
            f"{n_sync} at {', '.join(sites)})")
        require(n_sync == 0, f"{like.name} adds no host-wait site")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sz.log_like(th32, state.P[:, post32.slices[sz.name]])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  SZ peak memory above its inputs: {peak / 2 ** 20:.1f} MiB for "
        f"{LSS_NCHAINS} chains in blocks of {sz.chain_block} "
        f"({peak / 2 ** 20 / LSS_NCHAINS:.1f} MiB a chain)")
    require(peak < 5 * 2 ** 30, "SZ peak under ~4 GB whatever the chains")
    log(f"  phase 12 part 1 took {time.time() - t_phase:.1f} s")
    return launches, per_segment


def action4_table(post):
    """Phase 12, part 2: the action=4 per-likelihood table on phase 3's
    posterior (plik_lite + tau prior, float32) at the best fit: its values
    sum to that point's -logL without priors (the raw posterior)."""
    truth = bestfit_vector(post)
    table = post.per_likelihood(truth)
    raw, _ = post.raw_logpost()(torch.as_tensor(truth[None], dtype=post.dtype,
                                                device=post.device))
    log("phase 12: action=4 table on the flagship at the best fit: "
        + ", ".join(f"{n} {v:.6e}" for n, v in table.items())
        + f"; -logL without priors {float(raw[0]):.6e}")
    require(list(table) == [like.name for like in post.likes.likes],
            "a row per likelihood")
    require(abs(sum(table.values()) - float(raw[0]))
            <= 1e-5 * max(1.0, abs(float(raw[0]))),
            "the action=4 table sums to -logL without priors")


def write_ini(path, keys):
    """An ini file of `key = value` lines."""
    with open(path, "w") as f:
        f.writelines(f"{k} = {v}\n" for k, v in keys.items())
    return path


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def start_clis(runs):
    """`python -m <args>` of each (args, what, expect_rc) of `runs`, started
    from the checkout (port_clis collects them)."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen([sys.executable, "-m", *args], cwd=HERE, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for args, _, _ in runs]


def port_cli(args, what, expect_rc=0):
    """`python -m <args>` from the checkout, as a user runs it; its output
    goes to the log, its exit code must be `expect_rc`."""
    return port_clis([(args, what, expect_rc)])[0]


def port_clis(runs, procs=None):
    """Each (args, what, expect_rc) of `runs` as port_cli runs it, all
    started together (each new process builds its host tables anew, so
    they overlap), or the processes `procs` of `start_clis` already running
    them; returns their standard outputs in order."""
    procs = procs or start_clis(runs)
    outs = []
    try:
        for proc, (_, what, expect_rc) in zip(procs, runs):
            out, err = proc.communicate(timeout=600)
            for line in (out + err).strip().splitlines()[-12:]:
                log(f"  | {line}")
            require(proc.returncode == expect_rc,
                    f"{what} exits {expect_rc} (got {proc.returncode})")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def mll_at(post, P):
    """-logL (float64 numpy) of `post` at the (C, n) points P."""
    with torch.no_grad():
        return post.logpost()(torch.as_tensor(
            P, dtype=post.dtype, device=post.device))[0].double().cpu().numpy()


def flagship_cli_runs(dev, d, fid):
    """Phase 13's step 1, started ahead of the phase (its two processes
    spend ~60 s each on the host's first flagship pass): the flagship ini
    written under `d`, -logL of the same posterior built by hand at the
    centre, and the two CLI processes of action 4 running. Returns what
    `driver_flagship` reads back."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    os.makedirs(d, exist_ok=True)
    bbn = sd.write_bbn_table(os.path.join(d, "bbn_grid.dat"))
    hst = dict(H0=73.48, H0_err=1.66)
    flag = write_ini(os.path.join(d, "flagship.ini"), {
        "file_root": os.path.join(d, "chains", "flagship"),
        "pliklite_dataset": fid["ds"], "bao_dataset[DR12]": fid["dr12"],
        "prior[tau]": "0.0544 0.0073", "bbn_table": bbn,
        "Hubble_H0": hst["H0"], "Hubble_H0_err": hst["H0_err"],
        "device": dev.type})
    hand = flagship_by_hand(dev, fid, bbn, None)
    centre = np.array([p.center for p in hand.space.varying])
    mll_hand = float(mll_at(hand, centre[None])[0])
    cli = ["cosmomc_tpu_torch", flag, "action=4", "use_float64=T"]
    runs = [(cli + [f"test_check_compare={mll_hand!r}"], "the CLI's action 4", 0),
            (cli + [f"test_check_compare={mll_hand + 1.0!r}"],
             "the CLI's action 4 one above the value", 1)]
    return dict(bbn=bbn, hst=hst, flag=flag, hand=hand, mll_hand=mll_hand,
                runs=runs, procs=start_clis(runs), t0=time.time())


def flagship_by_hand(dev, fid, bbn, hst):
    """The flagship ini's posterior in float64 (with HST where `hst` is
    given), built without the driver."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.hst import HSTLikelihood
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.models.bbn import load_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    par = ThetaParameterization()
    space = par.default_space()
    space.get("tau").prior_mean, space.get("tau").prior_std = 0.0544, 0.0073
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(fid["ds"], device=dev, dtype=F64))
    likes.add(BAOLikelihood(fid["dr12"], name="DR12", device=dev, dtype=F64))
    if hst:
        likes.add(HSTLikelihood(**hst))
    return CMBPosterior(par, space, likes, bbn_table=load_bbn_table(bbn),
                        device=dev, dtype=F64)


def driver_flagship(dev, d, fid, times, cli):
    """Phase 13's steps 1, 2 and 3 (drive_driver) on the flagship ini
    written under `d` (step 1's processes started by `flagship_cli_runs`,
    `cli`); adds each step's wall time to `times`, step 1's from its
    start. Returns step 2's launch counts and its launches a segment."""
    from cosmomc_tpu_torch import driver, kernels
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
    from cosmomc_tpu_torch.sampling import importance, runner
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    bbn, hst, flag = cli["bbn"], cli["hst"], cli["flag"]
    hand, mll_hand = cli["hand"], cli["mll_hand"]

    def by_hand(with_hst):
        return flagship_by_hand(dev, fid, bbn, hst if with_hst else None)

    # 1. the CLI, action 4 (running since `flagship_cli_runs`)
    t0 = cli["t0"]
    out, _ = port_clis(cli["runs"], cli["procs"])
    mll_cli = float(out.split("Test -log(Like) =")[1].split()[0])
    log(f"phase 13: CLI action=4 -logL {mll_cli:.10f}, by hand "
        f"{mll_hand:.10f} (rel diff {abs(mll_cli - mll_hand) / abs(mll_hand):.2e})")
    require(abs(mll_cli - mll_hand) <= DRIVER_MLL_RTOL * abs(mll_hand),
            "the CLI's -logL equals the posterior built by hand")
    times["1 CLI action 4"] = time.time() - t0

    # 2. action 0 on the flagship ini, its launches counted alone; rows are
    # written after one accept a block (RunConfig's default of 50 would
    # take far more than DRIVER_SEGMENTS segments)
    root0 = os.path.join(d, "chains", "flagship")
    at_init = {}
    real_init = StagedMetropolisSampler.init_state

    def init_state(self, P0):
        state = real_init(self, P0)
        torch.cuda.synchronize()
        at_init.update(kernels.launches)
        return state

    @dataclasses.dataclass
    class OneAcceptConfig(runner.RunConfig):
        burn_accepts_per_block: int = 1
    real_cfg = runner.RunConfig
    StagedMetropolisSampler.init_state = init_state
    runner.RunConfig = OneAcceptConfig
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        rc = driver.run_ini(flag, dict(
            action="0", use_float64="F", num_chains=str(NCHAINS),
            segment_steps=str(SEG_STEPS),
            samples=str(DRIVER_SEGMENTS * SEG_STEPS), MPI_R_Stop="0",
            feedback="0"))
        torch.cuda.synchronize()
        times["2 action 0"] = time.time() - t0
        launches = dict(kernels.launches)
    finally:
        StagedMetropolisSampler.init_state = real_init
        runner.RunConfig = real_cfg
    per_segment = {n: (launches[n] - at_init[n]) / DRIVER_SEGMENTS
                   for n in launches}
    log("phase 13: action 0 launches " + json.dumps(launches)
        + "; per segment " + json.dumps(per_segment))
    require(rc == 0, "action 0 exits 0")
    for n in KERNELS:
        if n in PATH_KERNELS["driver"]:
            require(launches[n] > 0, f"{n} launched by action 0")
        else:
            require(launches[n] == 0, f"{n} not launched by action 0")
    for ext in ("_1.txt", ".paramnames", ".ranges", ".converge_stat",
                ".inputparams", ".margestats", ".covmat", ".likestats"):
        require(os.path.isfile(root0 + ext), f"action 0 wrote {ext}")
    samples = MCSamples.load(root0, ignore_frac=0.0)
    require(samples.samples.shape[1] == hand.space.num_varying + hand.num_derived
            and len(samples.weights) > 0
            and bool(np.isfinite(samples.samples).all()),
            "MCSamples reads the chains back")
    log(f"  {len(samples.weights)} rows, weight {samples.norm:.0f}, R-1 "
        f"{samples.converge_tests()['R-1']:.3f}")

    # 3. action 1: the chains reweighted with HST added, float64
    got = []
    real_arrays = importance.importance_sample_arrays

    def arrays(*a, **k):
        got.append(real_arrays(*a, **k))
        return got[-1]
    importance.importance_sample_arrays = arrays
    try:
        t0 = time.time()
        rc = driver.run_ini(flag, dict(
            action="1", redo_root=root0, use_HST="T", use_float64="T",
            file_root=os.path.join(d, "chains", "flagship_hst")))
        torch.cuda.synchronize()
        times["3 action 1"] = time.time() - t0
    finally:
        importance.importance_sample_arrays = real_arrays
    w = np.concatenate([r.weights for r in got])
    eff = float(w.sum() ** 2 / (len(w) * (w ** 2).sum()))
    rows = got[0].samples[:3]
    mll_rows = mll_at(by_hand(True), rows)
    err = np.abs(got[0].mloglike[:3] - mll_rows) / np.abs(mll_rows)
    log(f"phase 13: action 1 on {len(w)} rows in blocks of "
        f"{importance.CMB_BATCH}: eff_frac {eff:.4f}; three rows' -logL "
        f"{got[0].mloglike[:3]} vs by hand {mll_rows} (rel {err.max():.2e})")
    require(rc == 0 and 0.0 < eff <= 1.0, "action 1 eff_frac in (0, 1]")
    require(bool((err <= DRIVER_MLL_RTOL).all()),
            "action 1's -logL equals the posterior's own")
    require(os.path.isfile(os.path.join(d, "chains", "flagship_hst_post_1.txt")),
            "action 1 wrote the post chains")

    return launches, per_segment


def driver_background(dev, d, bg, times):
    """Phase 13's steps 4 and 6 (drive_driver) on the background ini
    written under `d` from phase 6's sets `bg`; adds each step's wall time
    to `times`. Runs on the CPU too (`dev` the CPU device: the inis then
    carry device = cpu)."""
    from cosmomc_tpu_torch import driver
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.utils.ini import IniFile

    # 4. action 2 and HMC on the background ini (autograd on the card)
    bgkeys = {"parameterization": "background",
              "bao_dataset[DR12]": bg["dr12"], "bao_dataset[6DF]": bg["sixdf"],
              "sn_dataset[Pantheon]": bg["sn"], "use_HST": "T",
              "Hubble_H0": repr(bg["hst_h0"]), "Hubble_H0_err": "1.66",
              "device": dev.type}
    bgini = write_ini(os.path.join(d, "background.ini"), {
        "file_root": os.path.join(d, "chains", "background"), **bgkeys})
    t0 = time.time()
    require(driver.run_ini(bgini, {"action": "2"}) == 0, "action 2 exits 0")
    times["4 action 2"] = time.time() - t0
    post = driver.build_posterior(IniFile(bgini))
    centre = np.array([p.center for p in post.space.varying])
    mll_c = float(mll_at(post, centre[None])[0])
    root2 = os.path.join(d, "chains", "background")
    with open(root2 + ".minimum") as f:
        mll_min = float(f.read().split("-log(Like) =")[1].split()[0])
    ev = np.linalg.eigvalsh(np.loadtxt(root2 + ".hessian.covmat"))
    log(f"phase 13: action 2 -logL {mll_min:.6f} (centre {mll_c:.6f}); Hessian "
        f"covmat eigenvalues {ev}")
    require(mll_min <= mll_c, ".minimum at or below the centre's -logL")
    require(bool((ev > 0).all()), "the Hessian covmat is positive definite")
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.run_ini(bgini, {
            "action": "0", "sampling_method": "hmc", "MPI_R_Stop": "0",
            "feedback": "0", "file_root": os.path.join(d, "chains", "hmc"),
            **{k: str(v) for k, v in DRIVER_HMC.items()}})
    times["4 HMC"] = time.time() - t0
    log(buf.getvalue().strip())
    acc = float(buf.getvalue().split("accept =")[1].split(",")[0])
    hmc = MCSamples.load(os.path.join(d, "chains", "hmc"), ignore_frac=0.0)
    sig = np.sqrt(np.diag(hmc.cov()))
    means = hmc.means()
    require(rc == 0 and acc > 0.4, "HMC accepts more than 0.4")
    for i, name in enumerate(p.name for p in post.space.varying):
        pull = (means[i] - sd.BACKGROUND_TRUTH[name]) / sig[i]
        log(f"  HMC {name}: mean {means[i]:.6g} +- {sig[i]:.4g} (truth "
            f"{sd.BACKGROUND_TRUTH[name]}, {pull:+.2f} sigma)")
        if name in ("omegam", "H0"):
            require(abs(pull) < 3.0, f"HMC {name} within 3 sigma of the truth")

    # 6. the grid CLI: one background job and its HST importance rerun
    t0 = time.time()
    frag = write_ini(os.path.join(d, "bg_data.ini"), {**bgkeys, "use_HST": "F"})
    settings = os.path.join(d, "grid_settings.json")
    with open(settings, "w") as f:
        json.dump({"params": [[]], "datasets": [[["bg"], [frag]]],
                   "importance_runs": [["HST", {"use_HST": "T"}]],
                   "defaults": {"MPI_R_Stop": "0", "feedback": "0",
                                **{k: str(v) for k, v in DRIVER_GRID.items()}}},
                  f)
    grid = os.path.join(d, "grid")
    port_cli(["cosmomc_tpu_torch.grid", "make", grid, settings], "grid make")
    out = port_cli(["cosmomc_tpu_torch.grid", "run", grid], "grid run")
    require("base_bg: rc=0" in out and "base_bg_post_HST: rc=0" in out,
            "grid run: both jobs exit 0")
    out = port_cli(["cosmomc_tpu_torch.grid", "status", grid], "grid status")
    require("base_bg " in out and "chains=1" in out, "grid status lists the job")
    require(os.path.isfile(os.path.join(grid, "base", "bg_post_HST",
                                        "base_bg_post_HST_post_1.txt")),
            "the importance rerun wrote its chains")
    times["6 grid"] = time.time() - t0


def drive_driver(dev, tmp, fid, bg, cli):
    """Phase 13: the ini driver, `python -m cosmomc_tpu_torch params.ini`,
    and the tools it dispatches to, on inis written from phase 3's plik_lite
    fiducial, phase 5's DR12-shaped BAO set and phase 6's background sets:
      1. the CLI, action 4 on the flagship ini in float64, as a subprocess
         (`cli`: started by `flagship_cli_runs` after phase 12): -logL
         equal to the same posterior built by hand (DRIVER_MLL_RTOL),
         test_check_compare passing at that value and failing (exit 1)
         one above it;
      2. action 0 on the flagship ini (float32, NCHAINS chains,
         DRIVER_SEGMENTS segments of SEG_STEPS steps, MPI_R_Stop = 0):
         exactly K4, K1, K2a and K3 launched, the chain files and sidecars
         and the GetDist outputs written, MCSamples reading them back;
      3. action 1 on those chains with HST added, float64: eff_frac in
         (0, 1], three rows' new -logL equal to the hand-built posterior's
         (DRIVER_MLL_RTOL);
      4. action 2 and sampling_method = hmc on the background ini, float64
         with autograd on the card: the .minimum at or below the centre's
         -logL, a positive definite Hessian covmat; HMC accepting > 0.4
         with omegam and H0 within 3 pooled sigma of the truth;
      5. (since the flagship takes gradients, its action 2 and HMC are
         phase 15's; LCDM+r's HMC is phase 17's);
      6. `python -m cosmomc_tpu_torch.grid make / run / status` on a
         one-job background grid with one importance rerun (HST added).
    Returns step 2's launch counts and its launches a segment."""
    t_phase = time.time()
    times = {}
    d = os.path.join(tmp, "driver")
    os.makedirs(d, exist_ok=True)
    launches, per_segment = driver_flagship(dev, d, fid, times, cli)
    driver_background(dev, d, bg, times)
    log(f"phase 13 took {time.time() - t_phase:.1f} s on {smi_line()}: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return launches, per_segment


# ---------------------------------------------------------------------------
# the reverse kernels (phase 2) and the gradient path (phase 14)
# ---------------------------------------------------------------------------

def _job_env(threads):
    return dict(os.environ, OMP_NUM_THREADS=str(threads),
                PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))


#: the host-CPU jobs whose results only phases 14-16 read: they run at a
#: lower scheduling priority (nice), so that the main process's host-bound
#: phases and the card's plain versions take the cores first
LATE_JOBS = ("--cpu-grad", "--cpu-grad-cmb", "--cpu-grad-ext", "--cpu-grad-lcdm-r")


def start_job(mode, d):
    """This script in `mode` (a key of JOB_THREADS) on the directory `d`,
    in a process of its own beside the main one's phases: on the host's
    CPU, or on the card (--plain-card*); its output goes to d/<mode>.log."""
    log_f = open(os.path.join(d, mode.strip("-") + ".log"), "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, d],
                            cwd=HERE, env=_job_env(JOB_THREADS[mode]),
                            stdout=log_f, stderr=subprocess.STDOUT,
                            preexec_fn=(lambda: os.nice(10)) if mode in LATE_JOBS
                            else None,
                            # phase 2's process starts jobs of its own: one
                            # process group, stopped as one (stop_job)
                            start_new_session=mode == "--phase2")
    proc.log_f = log_f
    proc.group = mode == "--phase2"
    return proc


def stop_job(proc):
    """Kill a job of start_job still running (with its own jobs)."""
    if proc.poll() is None:
        if getattr(proc, "group", False):
            os.killpg(proc.pid, signal.SIGKILL)
        else:
            proc.kill()
        proc.wait()


def finish_job(proc, d, name, what):
    """Wait for a job of start_job and load its result d/<name>."""
    t0 = time.time()
    try:
        rc = proc.wait(timeout=JOB_TIMEOUT)
    finally:
        stop_job(proc)
        proc.log_f.close()
    with open(proc.log_f.name) as f:
        tail = f.read().strip().splitlines()[-6:]
    for line in tail:
        log(f"  | {line}")
    require(rc == 0, f"{what} (a process on the host CPU) exits 0")
    log(f"  {what}: waited {time.time() - t0:.1f} s for it")
    return torch.load(os.path.join(d, name))


def reverse_inputs(dev, d):
    """Phase 2's reverse-kernel checks, their inputs, written to
    d/inputs.pt for the plain references' process (`plain_references`):
    K4's z table at NCHAINS chains x 8000 nodes at phase 2's cosmologies;
    K1's stage table on the matter grid (216 k to 8/Mpc) at NCHAINS chains x
    K1_CMP_STEPS steps; both rounded to float32, so that the float32
    kernels read the numbers the float64 references read. Seeded
    cotangents: K4's on x_e and T_M; K1's dense on the 7 planes of chains
    0-3 and, on chains 4-7, the matter path's sparse ones: dm, dmdot and
    weyl at the two grid rows around each of Z_PK's snapshots (what
    evolve_perturbations interpolates)."""
    from cosmomc_tpu_torch.models import matterpower as mpw
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models import recfast as mrec
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.utils.interp import interp

    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (NCHAINS, 1))
    for name in ("ombh2", "omch2", "theta", "tau"):
        full[:, space.index(name)] = BESTFIT[name] * (
            1 + 0.002 * rng.standard_normal(NCHAINS))
    full = torch.as_tensor(full, dtype=F64, device=dev)
    bg = par.to_background(full)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, F64))
    fHe = yhe / (mrec.const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = mrec.const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt = mrec._z_tables(bg, mrec.z_grid(mrec.N_Z, dev, F64), fHe, Nnow)
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    kgrid = mpw.matter_k_grid()
    tf, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=K1_CMP_STEPS,
                                     kmax=float(kgrid[-1]))
    q = mpert._stage_tables(bg, tf)
    tf6, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=6144,
                                      kmax=float(kgrid[-1]))
    q6 = mpert._stage_tables(bg, tf6)
    C, S, nk = NCHAINS, q.shape[1], len(kgrid)
    g = torch.Generator().manual_seed(14)
    g_out = torch.zeros(len(mpert.PLANES), C, S, nk, dtype=F64)
    half = C // 2
    g_out[:, :half] = torch.randn(len(mpert.PLANES), half, S, nk, generator=g,
                                  dtype=F64)
    # the rows the snapshots read: the nodes around tau(z), node j being the
    # planes' step j - 1
    lna_tab, tau_tab = mpert._conformal_time_table(bg)
    a_out = torch.tensor([1.0 / (1.0 + z) for z in Z_PK], dtype=F64, device=dev)
    tau_out = interp(torch.log(a_out).expand(C, -1), lna_tab.expand(C, -1),
                     tau_tab)
    node = torch.searchsorted(tf.tau.contiguous(), tau_out.contiguous()).cpu()
    for c in range(half, C):
        for j in node[c].tolist():
            for s in (j - 2, j - 1):
                if 0 <= s < S:
                    for p in ("dm", "dmdot", "weyl"):
                        g_out[mpert.PLANES.index(p), c, s] = torch.randn(
                            nk, generator=g, dtype=F64)
    r32 = lambda t: t.float().double().cpu().contiguous()
    inputs = dict(zt=r32(zt), fHe=r32(fHe),
                  g_xe=torch.randn(C, mrec.N_Z, generator=g, dtype=F64),
                  g_tm=1e-3 * torch.randn(C, mrec.N_Z, generator=g, dtype=F64),
                  qtab=r32(q), k=r32(torch.as_tensor(kgrid)),
                  rnu=r32(mpert._r_nu(bg)), iso=torch.zeros(C, 3, dtype=F64),
                  g_out=g_out, qtab6144=r32(q6))
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    # K1 on the CMB source grid (248 k, the flagship's 8192 steps), the
    # cotangents dense on the four source planes K2a reads
    from cosmomc_tpu_torch.models.cmb import source_k_grid
    kc = torch.as_tensor(source_k_grid(kmax=0.5), dtype=F64, device=dev)
    tfc, _ = mpert.build_thermo_funcs(bg, yhe, th, zre)
    qc = mpert._stage_tables(bg, tfc)
    torch.save(dict(qtab=r32(qc), k=r32(kc), rnu=inputs["rnu"],
                    iso=inputs["iso"]), os.path.join(d, "inputs_cmb.pt"))
    log(f"phase 2 (reverse): inputs written; K4 {C} chains x {mrec.N_Z} z, K1 "
        f"{C} chains x {nk} k x {S} steps (matter grid) and x {len(kc)} k x "
        f"{qc.shape[1]} steps (CMB grid), {GRAD_CHUNKS} chunks; the plain "
        f"references run on the host CPU beside the card's phases")


def plain_references(d):
    """--plain-ref DIR: autograd of the plain K4 and K1 versions (float64, on
    the host CPU: their step loops are launch-bound on the card, where K4's
    took minutes) on DIR/inputs.pt; writes DIR/refs.pt with each
    gradient and the seconds it took."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models import recfast as mrec
    torch.set_num_threads(JOB_THREADS["--plain-ref"])
    inp = torch.load(os.path.join(d, "inputs.pt"))
    out = {}
    t0 = time.time()
    zt = inp["zt"].requires_grad_(True)
    fHe = inp["fHe"].requires_grad_(True)
    xe, tm = mrec._scan_plain(zt, fHe)
    g_zt, g_fhe = torch.autograd.grad(
        (xe * inp["g_xe"]).sum() + (tm * inp["g_tm"]).sum(), [zt, fHe])
    out["recfast_bwd"] = dict(g=(g_zt, g_fhe), seconds=time.time() - t0)
    print(f"K4 plain forward + backward {out['recfast_bwd']['seconds']:.1f} s",
          flush=True)
    t0 = time.time()
    q, rnu, iso = (inp[n].requires_grad_(True) for n in ("qtab", "rnu", "iso"))
    o = mpert._evolve_plain(q, inp["k"], rnu, mpert.RSA_KTAU, iso=iso,
                            remat_chunks=GRAD_CHUNKS)
    g = torch.autograd.grad((o * inp["g_out"]).sum(), [q, rnu, iso])
    out["boltzmann_bwd"] = dict(g=g, seconds=time.time() - t0)
    print(f"K1 plain forward + backward {out['boltzmann_bwd']['seconds']:.1f} s",
          flush=True)
    torch.save(out, os.path.join(d, "refs.pt"))
    return 0


def cmb_cotangent(C, S, nk):
    """The seeded cotangent of K1's planes on the CMB grid, (7, C, S, nk)
    float64 on the host: dense on the four source planes K2a reads (s0,
    s1, s2, slens), 0 on the matter planes; the same in every process."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    g = torch.Generator().manual_seed(16)
    out = torch.zeros(len(mpert.PLANES), C, S, nk, dtype=F64)
    for p in ("s0", "s1", "s2", "slens"):
        out[mpert.PLANES.index(p)] = torch.randn(C, S, nk, generator=g,
                                                 dtype=F64)
    return out


def plain_references_cmb(d):
    """--plain-ref-cmb DIR: autograd of the plain K1 version on the CMB
    grid (float64, host CPU) for the first CMB_REF_CHAINS chains of
    DIR/inputs_cmb.pt: chains do not couple, so their cotangents are those
    of the card's run over all NCHAINS; writes DIR/refs_cmb.pt."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    torch.set_num_threads(JOB_THREADS["--plain-ref-cmb"])
    inp = torch.load(os.path.join(d, "inputs_cmb.pt"))
    n = CMB_REF_CHAINS
    t0 = time.time()
    q, rnu, iso = (inp[k][:n].clone().requires_grad_(True)
                   for k in ("qtab", "rnu", "iso"))
    o = mpert._evolve_plain(q, inp["k"], rnu, mpert.RSA_KTAU, iso=iso,
                            remat_chunks=GRAD_CHUNKS)
    g_out = cmb_cotangent(NCHAINS, *o.shape[2:])[:, :n]
    g = torch.autograd.grad((o * g_out).sum(), [q, rnu, iso])
    out = dict(g=g, seconds=time.time() - t0)
    print(f"K1 (CMB grid, {n} chain(s)) plain forward + backward "
          f"{out['seconds']:.1f} s", flush=True)
    torch.save(out, os.path.join(d, "refs_cmb.pt"))
    return 0


def reverse_ops(name, inp, live=None):
    """Operations of a reverse kernel's function, counted as reverse mode
    costs at least: the forward's arithmetic again (the stage and Newton
    intermediates) and twice it for the adjoint, so 3 x OPS of the forward
    on the same work: K4 on the nodes from the first live one, K1 on every
    (chain, k, step) at 4 RHS a step."""
    if name == "recfast_bwd":
        return 3 * int(live) * OPS["recfast"]
    C, S = inp["qtab"].shape[:2]
    rhs, step = OPS["boltzmann"]
    return 3 * C * S * inp["k"].shape[0] * (4 * rhs + step)


def phase2_reverse(dev, results, d, job):
    """The reverse kernels against autograd of their plain versions on the
    inputs of `reverse_inputs` (the references from `plain_references`):
    float64 within 1e-9 of each output's largest magnitude, float32 within
    GRAD_F32_TOL; each pass timed (the forward with its stores, the
    backward) at 8 chains, K1 also at the matter path's 6144 steps, and
    bounded by `reverse_ops` and the bytes it reads and writes once."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models import recfast as mrec
    inp = {k: v.to(dev) for k, v in torch.load(
        os.path.join(d, "inputs.pt")).items()}
    got = {}
    # K4
    for dt in (F64, F32):
        zt, fHe = inp["zt"].to(dt), inp["fHe"].to(dt)
        gxe, gtm = inp["g_xe"].to(dt), inp["g_tm"].to(dt)
        mrec._recfast_launch(zt, fHe, True)
        fwd_ms, (xe, tm, st) = timed(lambda: mrec._recfast_launch(zt, fHe, True),
                                     reps=5)
        mrec._recfast_bwd(zt, fHe, st, tm, gxe, gtm)
        bwd_ms, gk = timed(lambda: mrec._recfast_bwd(zt, fHe, st, tm, gxe, gtm),
                           reps=5)
        # the same through autograd (the wrapper and _ThermoScan)
        z_, f_ = zt.clone().requires_grad_(True), fHe.clone().requires_grad_(True)
        xa, ta = mrec._scan_cuda(z_, f_)
        ga = torch.autograd.grad((xa * gxe).sum() + (ta * gtm).sum(), [z_, f_])
        require(all(bool(torch.equal(a, b)) for a, b in zip(ga, gk)),
                f"K4 reverse through autograd = the reverse kernel ({dt})")
        got["recfast_bwd", dt] = (gk, fwd_ms, bwd_ms, st, tm)
    # K1 on the matter grid
    chunk = -(-inp["qtab"].shape[1] // GRAD_CHUNKS)
    for dt in (F64, F32):
        q, k, rnu, iso, go = (inp[n].to(dt) for n in
                              ("qtab", "k", "rnu", "iso", "g_out"))
        run = lambda: mpert._evolve_launch(q, k, rnu, mpert.RSA_KTAU, False,
                                           False, iso, chunk)
        run()
        fwd_ms, (o, ck) = timed(run, reps=3)
        bwd = lambda: mpert._boltzmann_bwd(q, k, rnu, iso, ck, go,
                                           mpert.RSA_KTAU, chunk)
        bwd()
        bwd_ms, gk = timed(bwd, reps=2)
        q_ = q.clone().requires_grad_(True)
        oa = mpert._evolve_cuda(q_, k, rnu, mpert.RSA_KTAU, iso=iso,
                                remat_chunks=GRAD_CHUNKS)
        (ga,) = torch.autograd.grad((oa * go).sum(), [q_])
        require(bool(torch.equal(ga, gk[0])),
                f"K1 reverse through autograd = the reverse kernel ({dt})")
        got["boltzmann_bwd", dt] = (gk, fwd_ms, bwd_ms, ck, o)
    # K1 at the matter path's 6144 steps, NCHAINS chains (what HMC pays)
    S6, q6 = 6144, inp["qtab6144"]
    ms6 = {}
    for dt in (F32, F64):
        q, k, rnu, iso = (x.to(dt) for x in (q6, inp["k"], inp["rnu"], inp["iso"]))
        c6 = -(-q.shape[1] // GRAD_CHUNKS)
        go = torch.randn(len(mpert.PLANES), *q.shape[:2], k.shape[0],
                         dtype=dt, device=dev)
        o, ck = mpert._evolve_launch(q, k, rnu, mpert.RSA_KTAU, False, False,
                                     iso, c6)
        f_ms, _ = timed(lambda: mpert._evolve_launch(
            q, k, rnu, mpert.RSA_KTAU, False, False, iso, c6), reps=2)
        b_ms, _ = timed(lambda: mpert._boltzmann_bwd(
            q, k, rnu, iso, ck, go, mpert.RSA_KTAU, c6), reps=1)
        ms6[dt] = (f_ms, b_ms)
    refs = finish_job(job, d, "refs.pt", "the plain references")
    for name, outs in (("recfast_bwd", ("grad_zt", "grad_fHe")),
                       ("boltzmann_bwd", ("grad_qtab", "grad_rnu", "grad_iso"))):
        ref = [t.to(dev) for t in refs[name]["g"]]
        g64, fwd64, bwd64 = got[name, F64][:3]
        g32, fwd32, bwd32 = got[name, F32][:3]
        e32, a32 = [], []
        for o, a, b, r in zip(outs, g64, g32, ref):
            e = rel_err(a, r)
            log(f"  {name} {o}: float64 err {e:.3e}, float32 err "
                f"{rel_err(b, r):.3e} (of the largest |grad| {float(r.abs().max()):.4g})")
            require(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
                    f"{name} {o} finite")
            require(e <= 1e-9, f"{name} {o} float64 within 1e-9 of its plain version")
            e32.append(rel_err(b, r))
            a32.append(abs_err(b, r))
        require(max(e32) <= GRAD_F32_TOL[name],
                f"{name} float32 within {GRAD_F32_TOL[name]} of the float64 plain")
        if name == "recfast_bwd":
            live = int((inp["zt"].shape[2] - mrec.first_live_node(
                inp["zt"].float())).sum())
            ops = reverse_ops(name, inp, live)
            st, tm = got[name, F32][3:]
            moved = nbytes(inp["zt"].float(), inp["fHe"].float(), st, tm,
                           inp["g_xe"].float(), inp["g_tm"].float(),
                           *got[name, F32][0])
        else:
            ops = reverse_ops(name, inp)
            ck = got[name, F32][3]
            moved = nbytes(inp["qtab"].float(), inp["g_out"].float(), ck,
                           *got[name, F32][0])
        b = bound({"fp32": ops}, moved)
        results[name] = dict(max_abs_err=max(a32), ms=bwd32,
                             plain_ms=1e3 * refs[name]["seconds"],
                             fwd_with_stores_ms=fwd32, ms_f64=bwd64,
                             fwd_with_stores_ms_f64=fwd64,
                             plain_where="host CPU, float64, forward + backward",
                             **b)
        log(f"  {name}: forward with stores {fwd32:.3f} ms, backward {bwd32:.3f} "
            f"ms (float64 {fwd64:.3f} / {bwd64:.3f} ms); bound {b['bound_ms']:.4f} "
            f"ms ({b['bound_by']}); plain forward + backward on the host CPU "
            f"{refs[name]['seconds']:.1f} s")
    results["boltzmann_bwd"]["ms_6144_steps"] = ms6[F32][1]
    results["boltzmann_bwd"]["ms_6144_steps_f64"] = ms6[F64][1]
    log(f"  boltzmann at {S6 - 1} steps x {NCHAINS} chains x {inp['k'].shape[0]} k "
        f"(the matter path): forward with checkpoints {ms6[F32][0]:.2f} ms, "
        f"backward {ms6[F32][1]:.2f} ms (float64 {ms6[F64][0]:.2f} / "
        f"{ms6[F64][1]:.2f} ms)")


def phase2_reverse_cmb(dev, results, cmb, d, job):
    """The reverse kernels of the flagship's gradient at its shapes,
    against autograd of their plain versions, float64 within 1e-9 of each
    output's largest magnitude, float32 within GRAD_F32_TOL; each timed
    (the forward, the backward) and bounded by its reverse-mode operations
    and the bytes it reads and writes once:
      - los_bwd (K2a): phase 2's 8 chains x 109 l x 4521 k x 2048 tau (the
        8192-step sources, rounded to float32 so both precisions read the
        same numbers), a seeded cotangent on Delta_T, Delta_E, Delta_P; the
        plain version under autograd on the card, four chains a call;
      - lensing_bwd (K3): phase 2's 8 chains of unlensed spectra, l 2..2658
        -> 2508, 5315 theta, a seeded cotangent on the pass-3 sums; the
        plain version under autograd on the card for chains 0 and 1 (its
        graph holds ~4 GB a chain; chains do not couple);
      - boltzmann_bwd (K1) on the CMB grid: 8 chains x 248 k x 8191 steps in
        GRAD_CHUNKS chunks, the cotangent dense on the four source planes
        (`cmb_cotangent`); the plain version under autograd on the host CPU
        for the first CMB_REF_CHAINS chain(s) (`--plain-ref-cmb`)."""
    from cosmomc_tpu_torch.models import cls as mcls
    from cosmomc_tpu_torch.models import lensing as mlens
    from cosmomc_tpu_torch.models import perturbations as mpert

    def compare(name, names, k64, k32, ref, sub=slice(None)):
        e64, e32, a32 = [], [], []
        for n, a, b, r in zip(names, k64, k32, ref):
            a, b = a[sub], b[sub]
            require(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
                    f"{name} {n} finite")
            e64.append(rel_err(a, r))
            e32.append(rel_err(b, r))
            a32.append(abs_err(b, r))
            log(f"  {name} {n}: float64 err {e64[-1]:.3e}, float32 err "
                f"{e32[-1]:.3e} (of the largest |grad| {float(r.abs().max()):.4g})")
        require(max(e64) <= 1e-9, f"{name} float64 within 1e-9 of its plain version")
        require(max(e32) <= GRAD_F32_TOL[name],
                f"{name} float32 within {GRAD_F32_TOL[name]} of the float64 plain")
        return max(a32), max(e64)

    # ---- K2a reverse
    po64, chi, kgrid = cmb["po64"], cmb["chi"], cmb["kgrid"]
    key = (2658, 14200.0, 0.5, 4.0, 256, tuple(np.asarray(kgrid, np.float64).tolist()))
    plan = mcls._plan(*key)
    fields = ("tau", "k", "s0", "s1", "s2", "slens", "tau0")
    po32 = po64._replace(**{f: getattr(po64, f).float().double() for f in fields})
    ins = {}
    for dt in (F64, F32):
        po = po32._replace(**{f: getattr(po32, f).to(dt) for f in fields})
        src, chi_arg, wt, wl = mcls._los_inputs(po, chi.float().to(dt), 4)
        ins[dt] = (src, mcls._device_plan(key, str(src.device), dt), chi_arg,
                   wt, wl, float(torch.tensor(1.0 / plan.dx, dtype=dt)))
    src, dp, chi_arg, wt, wl, inv_dx = ins[F64]
    C, _, nk, nt = src.shape
    nl, nkf = dp["ls"].shape[0], dp["kf"].shape[0]
    gen = torch.Generator().manual_seed(17)
    g = torch.zeros(3, C, nl, nkf, dtype=F64)
    g[:, :, :len(plan.ls), :len(plan.kf)] = torch.randn(
        3, C, len(plan.ls), len(plan.kf), generator=gen, dtype=F64)
    g = g.to(dev)
    got = {}
    for dt in (F64, F32):
        src, dp, chi_arg, wt, wl, inv_dx = ins[dt]
        gd = g.to(dt)
        fwd = lambda: mcls._los_cuda(src, dp, chi_arg, wt, wl, inv_dx)
        fwd()
        fwd_ms, _ = timed(fwd, 3)
        bwd = lambda: mcls._los_bwd_cuda(src, dp, chi_arg, wt, wl, inv_dx, gd)
        bwd()
        bwd_ms, gk = timed(bwd, 3)
        xs = [t.clone().requires_grad_(True) for t in (src, chi_arg, wt, wl)]
        out = mcls._Los.apply(*xs, dp, inv_dx)
        ga = torch.autograd.grad((out * gd).sum(), xs)
        require(all(bool(torch.equal(a, b)) for a, b in zip(ga, gk)),
                f"K2a reverse through autograd = the reverse kernel ({dt})")
        got[dt] = (gk, fwd_ms, bwd_ms)
    src, dp, chi_arg, wt, wl, inv_dx = ins[F64]
    torch.cuda.synchronize()
    t0 = time.time()
    ref = [[], [], [], []]
    for c0 in range(0, C, 4):
        sl = slice(c0, c0 + 4)
        xs = [t[sl].clone().requires_grad_(True) for t in (src, chi_arg, wt, wl)]
        out = mcls._los_plan_plain(xs[0], dp, xs[1], xs[2], xs[3], inv_dx)
        for r, x in zip(ref, torch.autograd.grad((out * g[:, sl]).sum(), xs)):
            r.append(x)
        del out
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    ref = [torch.cat(r, 0) for r in ref]
    err32, err64 = compare("los_bwd", ("grad_src", "grad_chi", "grad_wt", "grad_wl"),
                           got[F64][0], got[F32][0], ref)
    per_pt, per_knode = OPS["los_bwd"]
    s32 = ins[F32]
    b = bound({"fp32": C * nkf * nt * (nl * per_pt + per_knode)},
              nbytes(s32[0], s32[2], s32[3], s32[4], g.float(), s32[1]["packed"],
                     *got[F32][0]))
    results["los_bwd"] = dict(
        max_abs_err=err32, ms=got[F32][2], plain_ms=1e3 * plain_s,
        fwd_ms=got[F32][1], ms_f64=got[F64][2], fwd_ms_f64=got[F64][1],
        f64_rel_err=err64,
        plain_where="card, float64, autograd of _los_plan_plain, 4 chains a call",
        **b)
    log(f"  los_bwd: forward {got[F32][1]:.3f} ms, backward {got[F32][2]:.3f} ms "
        f"(float64 {got[F64][1]:.3f} / {got[F64][2]:.3f} ms); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); plain forward + backward on "
        f"the card {plain_s:.1f} s")
    del ref, got, ins
    torch.cuda.empty_cache()

    # ---- K3 reverse
    st64, ls = cmb["st64"], cmb["ls"]
    cl = mlens.lens_inputs(ls, *[x.float().double() for x in st64])
    C, _, L = cl.shape
    n_theta, nl_out = 2 * (L + 1), 2508 - 1
    gs = torch.randn(C, nl_out, 4, generator=gen, dtype=F64).to(dev)
    got = {}
    for dt in (F64, F32):
        c = cl.to(dt).contiguous()
        fwd = lambda: mlens._passes_launch(c, n_theta, True, nl_out)
        fwd()
        fwd_ms, (_, sgcg) = timed(fwd, 5)
        bwd = lambda: mlens._passes_bwd_cuda(c, sgcg, gs.to(dt), n_theta, True,
                                             nl_out)
        bwd()
        bwd_ms, gk = timed(bwd, 5)
        require(bool(torch.equal(gk, bwd())), f"lensing_bwd repeatable bit for bit ({dt})")
        x = c.clone().requires_grad_(True)
        (ga,) = torch.autograd.grad((mlens._passes_cuda(x, n_theta, True, nl_out)
                                     * gs.to(dt)).sum(), [x])
        require(bool(torch.equal(ga, gk)),
                f"K3 reverse through autograd = the reverse kernel ({dt})")
        got[dt] = (gk, fwd_ms, bwd_ms, sgcg)
    torch.cuda.synchronize()
    t0 = time.time()
    x = cl[:2].clone().requires_grad_(True)
    (ref,) = torch.autograd.grad((mlens._passes_grid_plain(x, n_theta, True, nl_out)
                                  * gs[:2]).sum(), [x])
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    names = ("grad_CTT", "grad_CTE", "grad_CEE", "grad_Cphil3")
    err32, err64 = compare("lensing_bwd", names,
                           [got[F64][0][:2, q] for q in range(4)],
                           [got[F32][0][:2, q] for q in range(4)],
                           [ref[:, q] for q in range(4)])
    ops = lensing_ops(C, L, n_theta - 1, nl_out)
    b = bound({"fp64": 3 * (ops["fp64"] + ops["fp64_tensor"])},
              nbytes(cl.float(), gs.float(), got[F32][3], got[F32][0]))
    results["lensing_bwd"] = dict(
        max_abs_err=err32, ms=got[F32][2], plain_ms=1e3 * plain_s,
        fwd_ms=got[F32][1], ms_f64=got[F64][2], fwd_ms_f64=got[F64][1],
        f64_rel_err=err64,
        plain_where="card, float64, autograd of _passes_plain, chains 0-1",
        **b)
    log(f"  lensing_bwd: forward {got[F32][1]:.3f} ms, backward {got[F32][2]:.3f} "
        f"ms (float64 {got[F64][1]:.3f} / {got[F64][2]:.3f} ms); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); plain forward + backward of "
        f"2 chains on the card {plain_s:.1f} s")
    del got, ref
    torch.cuda.empty_cache()

    # ---- K1 reverse on the CMB grid
    inp = {k: v.to(dev) for k, v in torch.load(
        os.path.join(d, "inputs_cmb.pt")).items()}
    S, nk = inp["qtab"].shape[1], inp["k"].shape[0]
    chunk = -(-S // GRAD_CHUNKS)
    g_out = cmb_cotangent(NCHAINS, S, nk).to(dev)
    got = {}
    for dt in (F64, F32):
        q, k, rnu, iso = (inp[n].to(dt) for n in ("qtab", "k", "rnu", "iso"))
        go = g_out.to(dt)
        run = lambda: mpert._evolve_launch(q, k, rnu, mpert.RSA_KTAU, False,
                                           False, iso, chunk)
        run()
        fwd_ms, (o, ck) = timed(run, 2)
        bwd = lambda: mpert._boltzmann_bwd(q, k, rnu, iso, ck, go,
                                           mpert.RSA_KTAU, chunk)
        bwd()
        bwd_ms, gk = timed(bwd, 1)
        got[dt] = (gk, fwd_ms, bwd_ms, ck)
    refs = finish_job(job, d, "refs_cmb.pt", "the CMB-grid K1 plain reference")
    n = CMB_REF_CHAINS
    ref = [t.to(dev) for t in refs["g"]]
    err32, err64 = compare("boltzmann_bwd", ("grad_qtab", "grad_rnu", "grad_iso"),
                           got[F64][0], got[F32][0], ref, sub=slice(0, n))
    b = bound({"fp32": reverse_ops("boltzmann_bwd", inp)},
              nbytes(inp["qtab"].float(), g_out.float(), got[F32][3], *got[F32][0]))
    results["boltzmann_bwd"].update(
        ms_cmb_grid=got[F32][2], ms_cmb_grid_f64=got[F64][2],
        fwd_with_checkpoints_ms_cmb_grid=got[F32][1],
        fwd_with_checkpoints_ms_cmb_grid_f64=got[F64][1],
        bound_ms_cmb_grid=b["bound_ms"], max_abs_err_cmb_grid=err32,
        f64_rel_err_cmb_grid=err64,
        plain_ms_cmb_grid=1e3 * refs["seconds"],
        plain_where_cmb_grid=f"host CPU, float64, forward + backward, {n} chain(s)")
    log(f"  boltzmann_bwd on the CMB grid ({NCHAINS} x {nk} k x {S} steps): "
        f"forward with checkpoints {got[F32][1]:.2f} ms, backward {got[F32][2]:.2f} "
        f"ms (float64 {got[F64][1]:.2f} / {got[F64][2]:.2f} ms); bound "
        f"{b['bound_ms']:.4f} ms; plain on the host CPU ({n} chain(s)) "
        f"{refs['seconds']:.1f} s")


#: K5's reverse kernel (phase 2): the reduced shape at which it is held to
#: autograd of its plain version on the host CPU (`--plain-ref-tensors`,
#: started by phase 2's process): the first and last of phase 2's chains x
#: the tensor grid's k 7, 15, .., 95 (12 of 96, 5.3e-5 to 0.065/Mpc) x
#: K1_CMP_STEPS - 1 steps, a seeded cotangent dense on the three planes;
#: the lanes cross tight coupling, the release (k tau >= 0.05) and the
#: freeze (k tau >= 240), which `tensor_switch_counts` requires
TENSOR_REF_CHAINS, TENSOR_REF_K = (0, NCHAINS - 1), slice(7, None, 8)
#: K6's reverse kernel (phase 2): the chains whose plain gradient autograd
#: takes on the card, one a call, its k chunks of TENSOR_LOS_REF_K_CHUNK fine k
#: (the same numbers as the default 64, a quarter of the graph)
TENSOR_LOS_REF_CHAINS, TENSOR_LOS_REF_K_CHUNK = (0, 1), 16


def tensor_reverse_inputs(dev, d):
    """The inputs of phase 2's checks of the tensor reverse kernels: phase
    2's cosmologies (as `reverse_inputs` draws them), the 8192-node grid's
    stage table (8 chains x 8191 steps) and the tensor k grid, K5's float32
    sources there (what K6 reads on the main path); and, written to
    d/inputs_tensors.pt for `plain_references_tensors`, the reduced-shape
    K5 problem (TENSOR_REF_*) rounded to float32, so that the float32
    kernel reads the numbers the float64 reference reads, with its seeded
    cotangent."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models import recfast as mrec
    from cosmomc_tpu_torch.models import tensors as mten
    from cosmomc_tpu_torch.models.background import BG_FIELDS
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization

    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (NCHAINS, 1))
    for name in ("ombh2", "omch2", "theta", "tau"):
        full[:, space.index(name)] = BESTFIT[name] * (
            1 + 0.002 * rng.standard_normal(NCHAINS))
    full = torch.as_tensor(full, dtype=F64, device=dev)
    bg = par.to_background(full)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, F64))
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    tf, tau0 = mpert.build_thermo_funcs(bg, yhe, th, zre)
    kt = torch.as_tensor(mten.tensor_k_grid(), dtype=F64, device=dev)
    r32 = lambda t: t.float().double().contiguous()
    tf32 = tf._replace(**{f: getattr(tf, f).float() for f in tf._fields})
    bg32 = type(bg)(**{f: getattr(bg, f).float() for f in BG_FIELDS},
                    num_massive_nu=bg.num_massive_nu)
    to32 = mten.evolve_tensors(bg32, tf32, tau0.float(), kt.float())
    tf1, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=K1_CMP_STEPS)
    q1 = mten._stage_table(bg, tf1, 1)[list(TENSOR_REF_CHAINS)]
    k1 = kt[TENSOR_REF_K]
    g = torch.Generator().manual_seed(18)
    g_out = torch.randn(3, len(TENSOR_REF_CHAINS), q1.shape[1], k1.shape[0],
                        generator=g, dtype=F64)
    torch.save(dict(qtab=r32(q1).cpu(), k=r32(k1).cpu(), g_out=g_out),
               os.path.join(d, "inputs_tensors.pt"))
    log(f"phase 2 (tensor reverse): inputs written; K5 held at "
        f"{len(TENSOR_REF_CHAINS)} chains x {k1.shape[0]} k x {q1.shape[1]} steps "
        f"on the host CPU, timed at {NCHAINS} x {kt.shape[0]} k x "
        f"{tf.tau.shape[1] - 1} steps; K6 at {NCHAINS} chains on K5's 8192-step "
        f"float32 sources")
    return dict(q=r32(mten._stage_table(bg, tf, 1)), kt=r32(kt), to32=to32)


def plain_references_tensors(d):
    """--plain-ref-tensors DIR: autograd of the plain K5 version (float64,
    host CPU: its step loop is launch-bound on the card) on
    DIR/inputs_tensors.pt, checkpointed in GRAD_CHUNKS chunks; writes
    DIR/refs_tensors.pt with the cotangent of qtab and the seconds it took."""
    from cosmomc_tpu_torch.models import tensors as mten
    torch.set_num_threads(JOB_THREADS["--plain-ref-tensors"])
    inp = torch.load(os.path.join(d, "inputs_tensors.pt"))
    t0 = time.time()
    q = inp["qtab"].clone().requires_grad_(True)
    out = mten._evolve_t_plain(q, inp["k"], 1, True, remat_chunks=GRAD_CHUNKS)
    (g,) = torch.autograd.grad((out * inp["g_out"]).sum(), [q])
    res = dict(g=g, seconds=time.time() - t0)
    print(f"K5 plain forward + backward {res['seconds']:.1f} s", flush=True)
    torch.save(res, os.path.join(d, "refs_tensors.pt"))
    return 0


def tensor_switch_counts(q, k):
    """(tight-coupling rows, held (k, step) lanes, released, frozen (k,
    row) evaluations) of the stage table q (C, S, R, NQT) on k: what the
    reduced K5 problem must cross."""
    from cosmomc_tpu_torch.models import tensors as mten
    tau = q[..., mten.QT_TAU]
    ktb = k * tau[:, :, -1, None]
    return dict(tc_rows=int((q[..., mten.QT_TC] > 0.5).sum()),
                held=int((ktb < mten.RELEASE_KTAU_T).sum()),
                released=int((ktb >= mten.RELEASE_KTAU_T).sum()),
                frozen=int((k * tau[..., None] >= mten.RSA_KTAU_T).sum()))


def phase2_reverse_tensors(dev, results, ten, d, job):
    """The reverse kernels of LCDM+r's tensor path against autograd of
    their plain versions, float64 within 1e-9 of each output's largest
    magnitude, float32 within GRAD_F32_TOL; each timed (the forward with
    its stores, the backward) and bounded by 3 x its forward's operations
    on the same work and the bytes it reads and writes once:
      - tensors_bwd (K5): timed at 8 chains x 96 k x 8191 steps in
        GRAD_CHUNKS chunks, a seeded cotangent on the three planes; held at
        the reduced shape (TENSOR_REF_*) to the host CPU's plain gradient
        (`--plain-ref-tensors`), bit for bit twice;
      - tensor_los_bwd (K6): 8 chains x 65 l x 610 fine k x 8192 tau on
        K5's float32 sources (upcast for float64), a seeded cotangent on
        Delta_T, Delta_E, Delta_B; the plain version under autograd on the
        card for TENSOR_LOS_REF_CHAINS, a chain a call."""
    from cosmomc_tpu_torch.models import tensors as mten

    def compare(name, names, k64, k32, ref):
        e64, e32, a32 = [], [], []
        for n, a, b, r in zip(names, k64, k32, ref):
            require(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
                    f"{name} {n} finite")
            e64.append(rel_err(a, r))
            e32.append(rel_err(b, r))
            a32.append(abs_err(b, r))
            log(f"  {name} {n}: float64 err {e64[-1]:.3e}, float32 err "
                f"{e32[-1]:.3e} (of the largest |grad| {float(r.abs().max()):.4g})")
        require(max(e64) <= 1e-9, f"{name} float64 within 1e-9 of its plain version")
        require(max(e32) <= GRAD_F32_TOL[name],
                f"{name} float32 within {GRAD_F32_TOL[name]} of the float64 plain")
        return max(a32), max(e64)

    # ---- K5 reverse at the main path's shape
    q64, kt = ten["q"], ten["kt"]
    C, S = q64.shape[:2]
    chunk = -(-S // GRAD_CHUNKS)
    g_full = torch.randn(3, C, S, kt.shape[0], generator=torch.Generator().manual_seed(19),
                         dtype=F64).to(dev)
    got = {}
    for dt in (F64, F32):
        q, k, go = q64.to(dt), kt.to(dt), g_full.to(dt)
        fwd = lambda: mten._evolve_t_launch(q, k, 1, True, chunk)
        fwd()
        fwd_ms, (_, ck) = timed(fwd, 2)
        bwd = lambda: mten._tensors_bwd(q, k, ck, go, 1, True, chunk)
        bwd()
        bwd_ms, gk = timed(bwd, 2)
        require(bool(torch.equal(gk, bwd())), f"tensors_bwd repeatable bit for bit ({dt})")
        q_ = q.clone().requires_grad_(True)
        (ga,) = torch.autograd.grad((mten._evolve_t_cuda(q_, k, 1, True, GRAD_CHUNKS)
                                     * go).sum(), [q_])
        require(bool(torch.equal(ga, gk)),
                f"K5 reverse through autograd = the reverse kernel ({dt})")
        require(bool(torch.isfinite(gk).all()), f"tensors_bwd finite ({dt})")
        got[dt] = (fwd_ms, bwd_ms, ck, gk)
    q32 = q64.float()
    b = bound({"fp32": 3 * k5_ops(q32, kt.float())},
              nbytes(q32, kt.float(), g_full.float(), got[F32][2], got[F32][3]))
    log(f"  tensors_bwd ({C} x {kt.shape[0]} k x {S} steps, {GRAD_CHUNKS} chunks): "
        f"forward with checkpoints {got[F32][0]:.3f} ms, backward {got[F32][1]:.3f} ms "
        f"(float64 {got[F64][0]:.3f} / {got[F64][1]:.3f} ms); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    timing = got
    # ... held at the reduced shape to the host CPU's plain gradient
    inp = {n: v.to(dev) for n, v in torch.load(
        os.path.join(d, "inputs_tensors.pt")).items()}
    sw = tensor_switch_counts(inp["qtab"], inp["k"])
    log(f"  tensors_bwd reduced shape {tuple(inp['g_out'].shape[1:])}: {json.dumps(sw)}")
    require(all(v > 0 for v in sw.values()), "the reduced K5 problem crosses every switch")
    Sr = inp["qtab"].shape[1]
    cr = -(-Sr // GRAD_CHUNKS)
    got = {}
    for dt in (F64, F32):
        q, k, go = (inp[n].to(dt) for n in ("qtab", "k", "g_out"))
        _, ck = mten._evolve_t_launch(q, k, 1, True, cr)
        got[dt] = mten._tensors_bwd(q, k, ck, go, 1, True, cr)
        require(bool(torch.equal(got[dt], mten._tensors_bwd(q, k, ck, go, 1, True, cr))),
                f"tensors_bwd repeatable bit for bit at the reduced shape ({dt})")
    ref = finish_job(job, d, "refs_tensors.pt", "the plain K5 reference")
    err32, err64 = compare("tensors_bwd", ("grad_qtab",), [got[F64]], [got[F32]],
                           [ref["g"].to(dev)])
    results["tensors_bwd"] = dict(
        max_abs_err=err32, ms=timing[F32][1], plain_ms=1e3 * ref["seconds"],
        fwd_with_checkpoints_ms=timing[F32][0], ms_f64=timing[F64][1],
        fwd_with_checkpoints_ms_f64=timing[F64][0], f64_rel_err=err64,
        plain_where=(f"host CPU, float64, forward + backward, "
                     f"{tuple(inp['g_out'].shape[1:])} (chains, steps, k)"),
        **b)
    del timing, got, inp
    torch.cuda.empty_cache()

    # ---- K6 reverse at the main path's shape
    kgrid_t = mten.tensor_k_grid()
    to32 = ten["to32"]
    fields = ("tau", "k", "sT", "sP", "tau0")
    got = {}
    g = None
    for dt in (F64, F32):
        to = to32._replace(**{f: getattr(to32, f).to(dt) for f in fields})
        args, grid = mten._tlos_inputs(to, 700, 14700.0, 0.065, 4.0, kgrid_t)
        if g is None:
            C, nl, nkf = args[0].shape[0], args[7].shape[0], args[4].shape[0]
            g = torch.randn(3, C, nl, nkf, generator=torch.Generator().manual_seed(20),
                            dtype=F64).to(dev)
        gd = g.to(dt)
        fwd = lambda: mten._tlos_cuda(*args)
        fwd()
        fwd_ms, _ = timed(fwd, 3)
        bwd = lambda: mten._tlos_bwd_cuda(*args, grid, gd)
        bwd()
        bwd_ms, gk = timed(bwd, 3)
        require(all(bool(torch.equal(a, b_)) for a, b_ in zip(gk, bwd())),
                f"tensor_los_bwd repeatable bit for bit ({dt})")
        xs = [args[i].clone().requires_grad_(True) for i in (0, 5, 6)]
        out = mten._TensorLos.apply(*xs, (*args[1:5], *args[7:]), grid)
        ga = torch.autograd.grad((out * gd).sum(), xs)
        require(all(bool(torch.equal(a, b_)) for a, b_ in zip(ga, gk)),
                f"K6 reverse through autograd = the reverse kernel ({dt})")
        got[dt] = (gk, fwd_ms, bwd_ms, args)
    args = got[F64][3]
    torch.cuda.synchronize()
    t0 = time.time()
    ref = [[], [], []]
    for c in TENSOR_LOS_REF_CHAINS:
        sl = slice(c, c + 1)
        xs = [args[i][sl].clone().requires_grad_(True) for i in (0, 5, 6)]
        out = mten._tlos_plain(xs[0], *args[1:5], xs[1], xs[2], *args[7:],
                               k_chunk=TENSOR_LOS_REF_K_CHUNK)
        for r, x in zip(ref, torch.autograd.grad((out * g[:, sl]).sum(), xs)):
            r.append(x)
        del out
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    ref = [torch.cat(r, 0) for r in ref]
    sub = list(TENSOR_LOS_REF_CHAINS)
    err32, err64 = compare("tensor_los_bwd", ("grad_src", "grad_chi", "grad_wt"),
                           [t[sub] for t in got[F64][0]], [t[sub] for t in got[F32][0]],
                           ref)
    a32 = got[F32][3]
    tabs = mten._TLOS_BY_TABLE[id(a32[7])]
    C, N = a32[5].shape
    nl, nkf = a32[7].shape[0], a32[4].shape[0]
    lat = mten.tlos_lattice(a32[5], a32[4], tabs["n0"], nl, a32[7].shape[1], a32[10])
    per_live, per_node = OPS["tensor_los"]
    b = bound({"fp32": 3 * (per_live * lat["live"] + per_node * C * nkf * N)},
              nbytes(a32[0], a32[5], a32[6], a32[7], a32[8], g.float(), *got[F32][0]))
    results["tensor_los_bwd"] = dict(
        max_abs_err=err32, ms=got[F32][2], plain_ms=1e3 * plain_s,
        fwd_ms=got[F32][1], ms_f64=got[F64][2], fwd_ms_f64=got[F64][1],
        f64_rel_err=err64,
        plain_where=(f"card, float64, autograd of _tlos_plain, chains "
                     f"{TENSOR_LOS_REF_CHAINS}, one a call"),
        **b)
    log(f"  tensor_los_bwd: forward {got[F32][1]:.3f} ms, backward {got[F32][2]:.3f} "
        f"ms (float64 {got[F64][1]:.3f} / {got[F64][2]:.3f} ms); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}); plain forward + backward of "
        f"{len(sub)} chains on the card {plain_s:.1f} s")
    del got, ref
    torch.cuda.empty_cache()


def ext_reverse_inputs(dev, d):
    """The inputs of phase 2's checks of K1's extended reverse kernels at
    the reduced shape (EXT_REF_*), written to d/inputs_ext.pt for the plain
    references' process (`plain_references_ext`): each instantiation's
    stage table, k, r_nu and the isocurvature inputs rounded to float32,
    and a seeded cotangent dense on all 7 planes."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    vi = VariantInputs(dev)
    ch = list(EXT_REF_CHAINS)
    r32 = lambda t: t.float().double().cpu().contiguous()
    ext = dict(k=r32(vi.k[::EXT_REF_K_STRIDE]), rnu=r32(vi.rnu[ch]),
               iso=r32(mpert.iso_inputs(vi.bg, vi.b)[ch]))
    for name, (_, sw) in EXT_BWD.items():
        ext[name] = r32(mpert._stage_tables(vi.bg, vi.tfs[K1_CMP_STEPS], *sw)[ch])
    g = torch.Generator().manual_seed(17)
    ext["g_out"] = torch.randn(len(mpert.PLANES), len(ch), ext[name].shape[1],
                               ext["k"].shape[0], generator=g, dtype=F64)
    torch.save(ext, os.path.join(d, "inputs_ext.pt"))
    return vi


def plain_references_ext(d, mode):
    """--plain-ref-nu|de|nu-de DIR: autograd of the plain K1 version of the
    extended instantiation PLAIN_REF_EXT_PARTS[mode] (float64, host CPU,
    GRAD_CHUNKS chunks) at the reduced shape of DIR/inputs_ext.pt; writes
    DIR/refs_<name>.pt."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    torch.set_num_threads(JOB_THREADS[mode])
    inp = torch.load(os.path.join(d, "inputs_ext.pt"))
    name = PLAIN_REF_EXT_PARTS[mode]
    sw = EXT_BWD[name][1]
    t0 = time.time()
    q, rnu, iso = (inp[n].clone().requires_grad_(True) for n in (name, "rnu", "iso"))
    o = mpert._evolve_plain(q, inp["k"], rnu, mpert.RSA_KTAU, *sw, iso=iso,
                            remat_chunks=GRAD_CHUNKS)
    g = torch.autograd.grad((o * inp["g_out"]).sum(), [q, rnu, iso])
    out = dict(g=g, seconds=time.time() - t0)
    print(f"{name}: plain forward + backward {out['seconds']:.1f} s", flush=True)
    torch.save(out, os.path.join(d, f"refs_{name}.pt"))
    return 0


def ext_switch_counts(q, k, sw):
    """(step, lane) pairs of K1's stage table q (C, S, 3, NQX) and the
    lanes k at whose end row each switch holds, and the lanes released from
    their ICs within the steps: the tight coupling, RSA (where the DE fluid
    freezes), nu_rel_rsa by (am < 2) and by k dt_loc > 0.9 (massive nu)."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    qb = q.double().cpu().numpy()[:, :, 2]
    k = k.double().cpu().numpy()[None, None, :]
    f = lambda i: qb[..., i][..., None]
    tau, opac, dtl = f(mpert.Q_TAU), f(mpert.Q_OPAC), f(mpert.Q_DTLOC)
    rsa = k * tau >= mpert.RSA_KTAU
    tc_off = (((k / np.maximum(opac, 1e-30) >= mpert.TC_KTAUC)
               | (opac * tau <= mpert.TC_OPACTAU))
              & (opac * (1.0 + f(mpert.Q_R)) * dtl <= 1.3))
    held = ~((k * tau >= mpert.IC_RELEASE_KTAU) | (tau >= 3.0))
    out = dict(held=held, tca=~tc_off & ~rsa & ~held,
               free=tc_off & ~rsa & ~held, rsa=rsa)
    if sw[0]:
        am = f(mpert.Q_AMLT2) != 0
        out.update(nu_rel_am=rsa & am, nu_rel_dt=rsa & ~am & (k * dtl > 0.9))
    counts = {n: int(v.sum()) for n, v in out.items()}
    counts["released_lanes"] = int((held.any(1) & (~held).any(1)).sum())
    return counts


def phase2_reverse_ext(dev, results, d, jobs, vi):
    """The reverse kernels of K1's extended instantiations (EXT_BWD):
      - timed (the forward with its checkpoints, the backward) at the main
        paths' shape, VariantInputs' 8 chains x 248 k x 8191 steps in
        GRAD_CHUNKS chunks (the cotangent on the four source planes,
        `cmb_cotangent`), and boltzmann_nu_bwd also on the matter grid, 8
        chains x 216 k x 6143 steps (the cotangent on dm, dmdot, weyl);
        bounded by 3 x the forward's operations (`k1_ops`) and the bytes
        read and written once;
      - at the reduced shape (EXT_REF_*, the lanes and steps crossing every
        switch), against autograd of their plain versions on the host CPU
        (`--plain-ref-*`): float64 within 1e-9 of each output's largest
        magnitude, float32 within GRAD_F32_TOL; two launches equal bit for
        bit, and the gradient through `_evolve_cuda` under autograd equal
        to the kernel's.
    `jobs`: the `--plain-ref-*` processes, in PLAIN_REF_EXT_PARTS' order."""
    from cosmomc_tpu_torch.models import matterpower as mpw
    from cosmomc_tpu_torch.models import perturbations as mpert
    iso_full = mpert.iso_inputs(vi.bg, vi.b)
    S_f, nk_f = vi.tfs[mpert.N_STEP].tau.shape[1] - 1, vi.k.shape[0]
    chunk_f = -(-S_f // GRAD_CHUNKS)
    g_cmb = cmb_cotangent(NCHAINS, S_f, nk_f).to(dev)
    for name, (fwd, sw) in EXT_BWD.items():
        qf = mpert._stage_tables(vi.bg, vi.tfs[mpert.N_STEP], *sw)
        t = {}
        for dt in (F32, F64):
            qd, kd, rd, idt, go = (x.to(dt) for x in (qf, vi.k, vi.rnu, iso_full,
                                                      g_cmb))
            run = lambda: mpert._evolve_launch(qd, kd, rd, mpert.RSA_KTAU, *sw,
                                               idt, chunk_f)
            run()
            fwd_ms, (_, ck) = timed(run, 2)
            bwd = lambda: mpert._boltzmann_bwd(qd, kd, rd, idt, ck, go,
                                               mpert.RSA_KTAU, chunk_f, *sw)
            bwd_ms, gk = timed(bwd, 1)
            require(all(bool(torch.isfinite(x).all()) for x in gk),
                    f"{name} finite at the main paths' shape ({dt})")
            t[dt] = (fwd_ms, bwd_ms, ck, gk)
            del ck, gk
        q32 = qf.float()
        b = bound({"fp32": 3 * k1_ops(q32, nk_f, fwd)},
                  nbytes(q32, g_cmb.float(), t[F32][2], *t[F32][3]))
        results[name] = dict(
            ms=t[F32][1], ms_f64=t[F64][1], fwd_with_checkpoints_ms=t[F32][0],
            fwd_with_checkpoints_ms_f64=t[F64][0],
            shape=f"{NCHAINS} chains x {nk_f} k x {S_f} steps, {GRAD_CHUNKS} chunks",
            **b)
        log(f"  {name} at {NCHAINS} x {nk_f} k x {S_f} steps: forward with "
            f"checkpoints {t[F32][0]:.2f} ms, backward {t[F32][1]:.2f} ms (float64 "
            f"{t[F64][0]:.2f} / {t[F64][1]:.2f} ms); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
        del t
    del g_cmb
    # boltzmann_nu_bwd on the matter grid (the second K1 launch of base_mnu)
    sw = (True, False)
    kg = torch.as_tensor(mpw.matter_k_grid(), dtype=F64, device=dev)
    bgm, tfm = vi.inputs(vi.full, (MATTER_CMP_STEPS[-1],), float(kg[-1]))
    qm = mpert._stage_tables(bgm, tfm[MATTER_CMP_STEPS[-1]], *sw)
    S_m, nk_m = qm.shape[1], kg.shape[0]
    chunk_m = -(-S_m // GRAD_CHUNKS)
    gen = torch.Generator(device=dev).manual_seed(16)
    g_m = torch.zeros(len(mpert.PLANES), NCHAINS, S_m, nk_m, dtype=F64, device=dev)
    for p in ("dm", "dmdot", "weyl"):
        g_m[mpert.PLANES.index(p)] = torch.randn(NCHAINS, S_m, nk_m, generator=gen,
                                                 device=dev, dtype=F64)
    t = {}
    for dt in (F32, F64):
        qd, kd, rd, go = qm.to(dt), kg.to(dt), mpert._r_nu(bgm).to(dt), g_m.to(dt)
        idt = torch.zeros(NCHAINS, 3, dtype=dt, device=dev)
        run = lambda: mpert._evolve_launch(qd, kd, rd, mpert.RSA_KTAU, *sw, idt,
                                           chunk_m)
        run()
        fwd_ms, (_, ck) = timed(run, 2)
        bwd = lambda: mpert._boltzmann_bwd(qd, kd, rd, idt, ck, go, mpert.RSA_KTAU,
                                           chunk_m, *sw)
        bwd_ms, gk = timed(bwd, 1)
        require(all(bool(torch.isfinite(x).all()) for x in gk),
                f"boltzmann_nu_bwd finite on the matter grid ({dt})")
        t[dt] = (fwd_ms, bwd_ms, ck, gk)
        del ck, gk
    b = bound({"fp32": 3 * k1_ops(qm.float(), nk_m, "boltzmann_nu")},
              nbytes(qm.float(), g_m.float(), t[F32][2], *t[F32][3]))
    results["boltzmann_nu_bwd"]["matter_grid"] = dict(
        shape=f"{NCHAINS} chains x {nk_m} k x {S_m} steps, {GRAD_CHUNKS} chunks",
        ms=t[F32][1], ms_f64=t[F64][1], fwd_with_checkpoints_ms=t[F32][0],
        fwd_with_checkpoints_ms_f64=t[F64][0],
        **{f: v for f, v in b.items() if f.startswith("bound")})
    log(f"  boltzmann_nu_bwd on the matter grid ({NCHAINS} x {nk_m} k x {S_m} "
        f"steps): forward with checkpoints {t[F32][0]:.2f} ms, backward "
        f"{t[F32][1]:.2f} ms (float64 {t[F64][0]:.2f} / {t[F64][1]:.2f} ms); bound "
        f"{b['bound_ms']:.4f} ms")
    del t, g_m

    # the reduced shape against the host CPU's plain gradients
    inp = {k: v.to(dev) for k, v in torch.load(
        os.path.join(d, "inputs_ext.pt")).items()}
    refs = {name: finish_job(j, d, f"refs_{name}.pt",
                             f"the plain gradient of {name}")
            for j, name in zip(jobs, PLAIN_REF_EXT_PARTS.values())}
    k, rnu, iso, g_out = inp["k"], inp["rnu"], inp["iso"], inp["g_out"]
    C, S = g_out.shape[1], g_out.shape[2]
    chunk = -(-S // GRAD_CHUNKS)
    shape = f"{C} chains x {k.shape[0]} k x {S} steps"
    names = ("grad_qtab", "grad_rnu", "grad_iso")
    for name, (fwd, sw) in EXT_BWD.items():
        q = inp[name]
        cnt = ext_switch_counts(q, k, sw)
        log(f"  {name} at {shape}: (step, lane) pairs a switch holds at "
            + json.dumps(cnt))
        for n, v in cnt.items():
            require(v > 0, f"{name}: the reduced shape crosses {n}")
        got = {}
        for dt in (F64, F32):
            qd, kd, rd, idt, go = (x.to(dt) for x in (q, k, rnu, iso, g_out))
            _, ck = mpert._evolve_launch(qd, kd, rd, mpert.RSA_KTAU, *sw, idt,
                                         chunk)
            gk = mpert._boltzmann_bwd(qd, kd, rd, idt, ck, go, mpert.RSA_KTAU,
                                      chunk, *sw)
            again = mpert._boltzmann_bwd(qd, kd, rd, idt, ck, go,
                                         mpert.RSA_KTAU, chunk, *sw)
            require(all(bool(torch.equal(a, b)) for a, b in zip(gk, again)),
                    f"{name} repeatable bit for bit ({dt})")
            xs = [x.clone().requires_grad_(True) for x in (qd, rd, idt)]
            o = mpert._evolve_cuda(xs[0], kd, xs[1], mpert.RSA_KTAU, *sw,
                                   iso=xs[2], remat_chunks=GRAD_CHUNKS)
            ga = torch.autograd.grad((o * go).sum(), xs)
            require(all(bool(torch.equal(a, b)) for a, b in zip(ga, gk)),
                    f"{name} through autograd = the reverse kernel ({dt})")
            got[dt] = gk
        ref = [x.to(dev) for x in refs[name]["g"]]
        e64, e32, a32 = [], [], []
        for n, a, b, r in zip(names, got[F64], got[F32], ref):
            require(bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()),
                    f"{name} {n} finite")
            e64.append(rel_err(a, r))
            e32.append(rel_err(b, r))
            a32.append(abs_err(b, r))
            log(f"    {n}: float64 err {e64[-1]:.3e}, float32 err {e32[-1]:.3e} "
                f"(of the largest |grad| {float(r.abs().max()):.4g})")
        require(max(e64) <= 1e-9, f"{name} float64 within 1e-9 of its plain version")
        require(max(e32) <= GRAD_F32_TOL[name],
                f"{name} float32 within {GRAD_F32_TOL[name]} of the float64 plain")
        results[name].update(
            max_abs_err=max(a32), plain_ms=1e3 * refs[name]["seconds"],
            f64_rel_err=max(e64), f32_rel_err=max(e32), compare_shape=shape,
            plain_where=f"host CPU, float64, forward + backward at {shape}")
        log(f"  {name}: plain forward + backward on the host CPU at {shape} "
            f"{refs[name]['seconds']:.1f} s")


def lss_paths(sets):
    """The file paths of `lss_bbn_sets`, for a process of its own."""
    return {k: sets[k] for k in ("d", "des", "abund", "dr12", "table_path")}


def gradient_posterior(dev, paths, dtype=F64, nonlinear=True):
    """Phase 12's posterior (the astro parameterization, use_cmb=False,
    matter power; WL, SZ, D/H, Yp, DR12 with f_sigma8) on the sets at
    `paths`, K1 checkpointed in GRAD_CHUNKS chunks for its gradient."""
    from cosmomc_tpu_torch.models.bbn import load_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import AstroParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    par = AstroParameterization()
    return CMBPosterior(par, par.default_space(),
                        lss_bbn_likes(dev, paths, nonlinear),
                        bbn_table=load_bbn_table(paths["table_path"]),
                        use_cmb=False, matter_power=True,
                        remat_chunks=GRAD_CHUNKS, device=dev, dtype=dtype)


def gradient_points(post):
    """Phase 14's points: the centre, and the centre + 0.3 proposal widths
    along a seeded normal draw."""
    c = np.array([p.center for p in post.space.varying])
    w = np.array([p.propose_width for p in post.space.varying])
    return np.stack([c, c + 0.3 * w * np.random.default_rng(14).standard_normal(
        len(c))])


@contextlib.contextmanager
def reduced_matter_grid():
    """CMBPosterior's matter transfers on CPU_GRAD_MATTER's grid at
    CPU_GRAD_STEPS steps while in the context."""
    from cosmomc_tpu_torch import pipeline
    from cosmomc_tpu_torch.models import matterpower as mpw
    real = pipeline.compute_matter_transfers

    def reduced(*a, **k):
        return real(*a, **{**k, "k": mpw.matter_k_grid(**CPU_GRAD_MATTER),
                           "n_step": CPU_GRAD_STEPS})
    pipeline.compute_matter_transfers = reduced
    try:
        yield
    finally:
        pipeline.compute_matter_transfers = real


def gradient_at_points(post):
    """-logL and its gradient at phase 14's two points, float64 numpy."""
    P = torch.as_tensor(gradient_points(post), dtype=F64,
                        device=post.device).requires_grad_(True)
    m, _ = post.logpost()(P)
    (g,) = torch.autograd.grad(m.sum(), P)
    return m.detach().double().cpu().numpy(), g.double().cpu().numpy()


def cpu_gradient(d):
    """--cpu-grad DIR: the float64 gradient of phase 14's -logL at its two
    points on the host CPU (the plain versions under autograd) on the sets
    named in DIR/sets.json, on the reduced matter grid; writes
    DIR/cpu_grad.pt."""
    torch.set_num_threads(JOB_THREADS["--cpu-grad"])
    with open(os.path.join(d, "sets.json")) as f:
        paths = json.load(f)
    post = gradient_posterior(torch.device("cpu"), paths)
    t0 = time.time()
    with reduced_matter_grid():
        m, g = gradient_at_points(post)
    out = dict(mll=torch.as_tensor(m), g=torch.as_tensor(g),
               seconds=time.time() - t0)
    print(f"astro gradient on the CPU in {out['seconds']:.1f} s", flush=True)
    torch.save(out, os.path.join(d, "cpu_grad.pt"))
    return 0


def hmc_ini(tmp, sets, extra):
    """The LSS + BBN configuration as an ini (`python -m cosmomc_tpu_torch`'s
    keys), float64, with `extra` keys."""
    d = os.path.join(tmp, "gradient")
    os.makedirs(d, exist_ok=True)
    keys = {"parameterization": "astro", "use_WL": "T",
            "wl_dataset[DES]": sets["des"], "use_SZ": "T",
            "sz_data_dir": sets["d"],
            "abundance_dataset[D]": sets["abund"][0],
            "abundance_dataset[Yp]": sets["abund"][1],
            "bao_dataset[DR12]": sets["dr12"], "bbn_table": sets["table_path"],
            "use_float64": "T", "feedback": "0", **extra}
    return write_ini(os.path.join(d, f"lss_{extra['action']}.ini"), keys), d


def start_hmc(tmp, sets):
    """Phase 14 (b), started before phase 13 so that the two overlap: `python
    -m cosmomc_tpu_torch` on the LSS + BBN ini with sampling_method = hmc."""
    ini, d = hmc_ini(tmp, sets, {"action": "0", "sampling_method": "hmc",
                                 "file_root": os.path.join(tmp, "gradient",
                                                           "chains", "hmc"),
                                 "MPI_R_Stop": "0",
                                 **{k: str(v) for k, v in GRAD_HMC.items()}})
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "cosmomc_tpu_torch", ini],
                            cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.t0 = time.time()
    return proc


def drive_gradient(dev, tmp, sets, cpu_job, jobdir, hmc_proc):
    """Phase 14: the gradient path, on phase 12's LSS + BBN configuration
    (K4 and K1 forward, their reverse kernels backward):
      a. torch.autograd.grad of the float64 -logL at the centre: exactly
         one launch of each of the four kernels; against central finite
         differences of -logL (step GRAD_FD_STEP x each parameter's
         proposal width, all points one batch, WL on the linear P(k)) within
         GRAD_FD_TOL of the largest component; on the reduced matter grid
         CPU_GRAD_MATTER, against the same gradient on the host CPU (the
         plain versions, `cpu_gradient`) within GRAD_CPU_TOL; the peak
         memory a chain of one HMC gradient at NCHAINS chains;
      b. `python -m cosmomc_tpu_torch` with sampling_method = hmc on the
         configuration's ini (GRAD_HMC; started before phase 13): exit 0,
         acceptance within GRAD_HMC_ACCEPT, chains MCSamples loads, finite;
      c. action = 2 on the same ini (in-process, the minimizer cut to
         GRAD_MIN_ITER L-BFGS-B iterations and GRAD_MIN_REFINE refine
         steps, as phase 13 cuts RunConfig): the .minimum
         at or below the centre's -logL, a symmetric positive definite
         .hessian.covmat.
    (The flagship's gradient is phase 15's.)
    Returns the launches of one gradient evaluation and of (a)-(c)."""
    from cosmomc_tpu_torch import driver, kernels
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
    from cosmomc_tpu_torch.sampling import minimize
    from cosmomc_tpu_torch.utils.ini import IniFile

    t_phase = time.time()
    # a. the gradient at the centre, and at a point off it (at the centre
    # the sets' own theory zeroes the WL and BAO parts of it)
    post = gradient_posterior(dev, sets)
    names = [p.name for p in post.space.varying]
    pts = gradient_points(post)
    n = pts.shape[1]
    mll_at(post, pts)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    P = torch.as_tensor(pts, dtype=F64, device=dev).requires_grad_(True)
    m, _ = post.logpost()(P)
    (g,) = torch.autograd.grad(m.sum(), P)
    torch.cuda.synchronize()
    t_grad = time.time() - t0
    one = dict(kernels.launches)
    for k in KERNELS:
        want = 1 if k in PATH_KERNELS["gradient"] else 0
        require(one[k] == want, f"one gradient launches {k} {want} time(s)")
    g = g.double().cpu().numpy()
    require(bool(np.isfinite(g).all()), "the gradient is finite")
    # the same two gradients on the host CPU's plain versions, both on the
    # reduced matter grid
    with reduced_matter_grid():
        m_r, g_r = gradient_at_points(post)
    ref = finish_job(cpu_job, jobdir, "cpu_grad.pt", "the CPU plain gradient")
    g_cpu, m_cpu = ref["g"].numpy(), ref["mll"].numpy()
    e_cpu = float(np.abs(g_r - g_cpu).max() / np.abs(g_cpu).max())
    log(f"  on the reduced matter grid ({CPU_GRAD_MATTER}, {CPU_GRAD_STEPS} "
        f"steps): -logL {m_r} on the card, {m_cpu} on the host CPU's "
        f"plain versions ({ref['seconds']:.1f} s there); gradients max rel "
        f"{e_cpu:.3e} (tol {GRAD_CPU_TOL})")
    require(e_cpu <= GRAD_CPU_TOL, "the card's gradient equals the CPU's")
    # finite differences (one batch): -logL is piecewise smooth (linear
    # interpolation on grids that move with the parameters, the TCA/RSA
    # switches and the IC release on the tau grid, recfast's selections),
    # and autograd, as jax.grad, differentiates the piece it is on; steps
    # of 1e-4 widths cross kinks (~1% off along omegam and H0 on an H100,
    # PERF.md), steps of 1e-6 widths do not. Halofit's 48-step bisection for
    # k_sigma has no derivative in either package (JAX matterpower.py:
    # 265-269), so the check takes WL on the linear P(k); the nonlinear
    # posterior's differences are logged beside it.
    h = GRAD_FD_STEP * np.array([p.propose_width for p in post.space.varying])

    def differences(p_):
        out = mll_at(p_, np.concatenate([x + s * np.diag(h) for x in pts
                                         for s in (1.0, -1.0)]))
        return np.stack([(out[2 * i * n:(2 * i + 1) * n]
                          - out[(2 * i + 1) * n:(2 * i + 2) * n]) / (2.0 * h)
                         for i in range(len(pts))])
    lin = gradient_posterior(dev, sets, nonlinear=False)
    Pl = torch.as_tensor(pts, dtype=F64, device=dev).requires_grad_(True)
    (gl,) = torch.autograd.grad(lin.logpost()(Pl)[0].sum(), Pl)
    gl = gl.double().cpu().numpy()
    t0 = time.time()
    fd = differences(lin)
    t_fd = time.time() - t0
    e_fd = float((np.abs(fd - gl).max(1) / np.abs(gl).max(1)).max())
    fd_nl = differences(post)
    e_nl = np.abs(fd_nl - g).max(1) / np.abs(g).max(1)
    log(f"phase 14: -logL {m.detach().cpu().numpy()} at the centre and off it; "
        f"the gradient of both in {t_grad:.2f} s ({n} parameters); finite "
        f"differences (step {GRAD_FD_STEP} x the proposal widths, "
        f"{2 * n * len(pts)} points a batch, {t_fd:.2f} s) against the gradient "
        f"with WL on the linear P(k): max |fd - grad| / max |grad| {e_fd:.3e} "
        f"(tol {GRAD_FD_TOL}); on halofit's P(k) {e_nl} (halofit's k_sigma "
        f"bisection carries no derivative, as in JAX)")
    for j in range(len(pts)):
        for i in np.argsort(-np.abs(fd[j] - gl[j]))[:4]:
            log(f"  [{j}] d(-logL)/d{names[i]:14s} linear WL {gl[j, i]: .9e} "
                f"fd {fd[j, i]: .9e}; halofit {g[j, i]: .9e} fd {fd_nl[j, i]: .9e}")
    require(e_fd <= GRAD_FD_TOL, "the gradient agrees with finite differences")
    # the peak memory of one HMC gradient, NCHAINS chains
    P8 = torch.as_tensor(post.start_positions(np.random.default_rng(0), NCHAINS),
                         dtype=F64, device=dev).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m8, _ = post.logpost()(P8)
    torch.autograd.grad(m8.sum(), P8)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  one HMC gradient at {NCHAINS} chains: peak memory "
        f"{peak / 2 ** 20:.1f} MiB ({peak / 2 ** 20 / NCHAINS:.1f} MiB a chain, "
        f"float64, {GRAD_CHUNKS} K1 chunks)")

    # b. HMC through the CLI
    out, err = hmc_proc.communicate(timeout=JOB_TIMEOUT)
    t_hmc = time.time() - hmc_proc.t0
    for line in (out + err).strip().splitlines()[-8:]:
        log(f"  | {line}")
    require(hmc_proc.returncode == 0, "the HMC CLI exits 0")
    acc = float(out.split("accept =")[1].split(",")[0])
    root = os.path.join(tmp, "gradient", "chains", "hmc")
    hmc = MCSamples.load(root, ignore_frac=0.0)
    lo, hi = GRAD_HMC_ACCEPT
    log(f"  HMC (CLI, {GRAD_HMC}): acceptance {acc:.3f}, {hmc.samples.shape[0]} "
        f"rows, {t_hmc:.1f} s from start (beside phase 13)")
    require(lo <= acc <= hi, f"HMC acceptance within {GRAD_HMC_ACCEPT}")
    require(hmc.samples.shape[0] > 0 and bool(np.isfinite(hmc.samples).all()),
            "MCSamples loads finite HMC chains")

    # c. action 2, in-process, the refine cut short
    ini, d = hmc_ini(tmp, sets, {"action": "2", "file_root": os.path.join(
        tmp, "gradient", "chains", "min")})
    real = minimize.find_best_fit
    kernels.reset_launches()
    t0 = time.time()
    try:
        minimize.find_best_fit = lambda *a, **k: real(
            *a, **{**k, "refine_steps": GRAD_MIN_REFINE, "refine_chains": 8,
                   "maxiter": GRAD_MIN_ITER})
        with contextlib.redirect_stdout(io.StringIO()):
            rc = driver.run_ini(ini)
    finally:
        minimize.find_best_fit = real
    t_min = time.time() - t0
    launches = dict(kernels.launches)
    root2 = os.path.join(tmp, "gradient", "chains", "min")
    with open(root2 + ".minimum") as f:
        mll_min = float(f.read().split("-log(Like) =")[1].split()[0])
    cov = np.loadtxt(root2 + ".hessian.covmat")
    ev = np.linalg.eigvalsh(0.5 * (cov + cov.T))
    mll_c = float(mll_at(driver.build_posterior(IniFile(ini)), pts[:1])[0])
    log(f"  action 2: -logL {mll_min:.6f} (centre {mll_c:.6f}) in {t_min:.1f} s; "
        f"Hessian covmat eigenvalues {ev.min():.3e} .. {ev.max():.3e}; launches "
        + json.dumps({k: v for k, v in launches.items() if v}))
    require(rc == 0 and mll_min <= mll_c + 1e-9, ".minimum at or below the centre")
    require(np.allclose(cov, cov.T, rtol=1e-10, atol=0.0) and bool((ev > 0).all()),
            "the Hessian covmat is symmetric positive definite")
    for k in KERNELS:
        require((launches[k] > 0) == (k in PATH_KERNELS["gradient"]),
                f"action 2 launches {k} only if on the gradient path")

    log(f"phase 14 took {time.time() - t_phase:.1f} s on {smi_line()}")
    return launches, one


# ---------------------------------------------------------------------------
# phase 15: the flagship's gradient
# ---------------------------------------------------------------------------

def smooth_plik_fiducial(d):
    """A plik_lite fiducial written from a smooth made-up spectrum (the one
    of tests/test_torch_grad_flagship.py), for the comparison with the host
    CPU, whose process starts before any posterior runs here."""
    from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
    l = np.arange(3001, dtype=np.float64)
    tt = 1000.0 + 5000.0 * np.exp(-((l - 220.0) / 250.0) ** 2)
    ee = 5.0 + 40.0 * np.exp(-((l - 1000.0) / 400.0) ** 2)
    te = 0.1 * np.sqrt(tt * ee) * np.cos(l / 150.0)
    theory_cl = os.path.join(d, "smooth.theory_cl")
    np.savetxt(theory_cl, np.column_stack([l, tt, te, ee, 0.01 * ee,
                                           1e-7 + 0 * l])[2:])
    return write_plik_lite_fiducial(os.path.join(d, "smooth_plik"), theory_cl)


def flagship_grad_posterior(dev, ds, dr12=None, nonlinear=True, cfg=None):
    """The flagship's posterior in float64 (plik_lite + the tau prior, and
    the DR12-shaped set when given), K1 checkpointed in GRAD_CHUNKS chunks."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    par = ThetaParameterization()
    space = par.default_space()
    space.get("tau").prior_mean, space.get("tau").prior_std = 0.0544, 0.0073
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(ds, name="plik_lite", device=dev, dtype=F64))
    if dr12:
        likes.add(BAOLikelihood(dr12, name="DR12", device=dev, dtype=F64))
    return CMBPosterior(par, space, likes, bbn_table=synthetic_bbn_table(),
                        nonlinear_lens=nonlinear, remat_chunks=GRAD_CHUNKS,
                        device=dev, dtype=F64, **(cfg or {}))


def flagship_grad_points(post):
    """Phase 15's points: the best fit, and it + 0.3 proposal widths along
    a seeded normal draw."""
    c = bestfit_vector(post)
    w = np.array([p.propose_width for p in post.space.varying])
    return np.stack([c, c + 0.3 * w * np.random.default_rng(15).standard_normal(
        len(c))])


def grad_at(post, pts):
    """-logL and its gradient at the points `pts`, float64 numpy."""
    P = torch.as_tensor(pts, dtype=F64, device=post.device).requires_grad_(True)
    m, _ = post.logpost()(P)
    (g,) = torch.autograd.grad(m.sum(), P)
    return m.detach().double().cpu().numpy(), g.double().cpu().numpy()


def cpu_gradient_cmb(d):
    """--cpu-grad-cmb DIR: the float64 gradient of the flagship's -logL at
    phase 15's two points on the host CPU (the plain versions under
    autograd) at FLAG_SMALL, on the plik_lite set named in DIR/flag.json;
    writes DIR/cpu_grad_cmb.pt."""
    torch.set_num_threads(JOB_THREADS["--cpu-grad-cmb"])
    with open(os.path.join(d, "flag.json")) as f:
        ds = json.load(f)["ds"]
    post = flagship_grad_posterior(torch.device("cpu"), ds, nonlinear=False,
                                   cfg=FLAG_SMALL)
    t0 = time.time()
    m, g = grad_at(post, flagship_grad_points(post))
    out = dict(mll=torch.as_tensor(m), g=torch.as_tensor(g),
               seconds=time.time() - t0)
    print(f"flagship gradient on the CPU in {out['seconds']:.1f} s", flush=True)
    torch.save(out, os.path.join(d, "cpu_grad_cmb.pt"))
    return 0


def flagship_ini(tmp, fid, extra):
    """The flagship (plik_lite, DR12-shaped BAO, the tau prior) as an ini,
    float64, with `extra` keys."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    d = os.path.join(tmp, "flagship_grad")
    os.makedirs(d, exist_ok=True)
    bbn = os.path.join(d, "bbn_grid.dat")
    if not os.path.exists(bbn):
        sd.write_bbn_table(bbn)
    keys = {"pliklite_dataset": fid["ds"], "bao_dataset[DR12]": fid["dr12"],
            "prior[tau]": "0.0544 0.0073", "bbn_table": bbn,
            "use_float64": "T", "feedback": "0", **extra}
    return write_ini(os.path.join(d, f"flagship_{len(os.listdir(d))}.ini"),
                     keys), d


def start_flagship_hmc(tmp, fid):
    """Phase 15 (d), started after phase 5 so that it runs beside phases
    6-14: `python -m cosmomc_tpu_torch` on the flagship ini with
    sampling_method = hmc."""
    ini, d = flagship_ini(tmp, fid, {
        "action": "0", "sampling_method": "hmc", "MPI_R_Stop": "0",
        "file_root": os.path.join(d_root(tmp), "chains", "hmc"),
        **{k: str(v) for k, v in FLAG_HMC.items()}})
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "cosmomc_tpu_torch", ini],
                            cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.t0 = time.time()
    return proc


def d_root(tmp):
    return os.path.join(tmp, "flagship_grad")


def drive_flagship_gradient(dev, tmp, fid, cpu_job, jobdir, hmc_proc):
    """Phase 15: the flagship's gradient at full width in float64 (K4, K1,
    K2a, K3 forward and their four reverse kernels), on phase 3's plik_lite
    fiducial and phase 5's DR12-shaped set, the tau prior:
      a. torch.autograd.grad of -logL (halofit lensing) at the best fit and
         off it: exactly one launch of each of the path's eight kernels;
      b. with nonlinear_lens=False (halofit's k_sigma bisection carries no
         derivative, in either package) against central differences of
         -logL (step GRAD_FD_STEP x each proposal width, one batch) within
         GRAD_FD_TOL of the largest component;
      c. at FLAG_SMALL (test_torch_slice.py's small config) on a smooth
         plik_lite fiducial, against the host CPU's plain gradient
         (`--cpu-grad-cmb`) within GRAD_CPU_TOL; the peak memory a chain of
         one HMC gradient at NCHAINS chains;
      d. `python -m cosmomc_tpu_torch` with sampling_method = hmc on the
         flagship ini (FLAG_HMC, started after phase 5): exit 0, its
         acceptance, chains that MCSamples loads;
      e. action = 2 on the same ini (in-process, the minimizer cut as in
         phase 14): the .minimum at or below the best fit's -logL, a
         symmetric positive definite .hessian.covmat, only the path's
         kernels launched.
    Returns the launches of (a)-(e) and of one gradient."""
    from cosmomc_tpu_torch import driver, kernels
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
    from cosmomc_tpu_torch.sampling import minimize
    from cosmomc_tpu_torch.utils.ini import IniFile

    t_phase = time.time()
    launches = {k: 0 for k in kernels.launches}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
    # a. the gradient, halofit lensing
    post = flagship_grad_posterior(dev, fid["ds"], fid["dr12"])
    names = [p.name for p in post.space.varying]
    pts = flagship_grad_points(post)
    n = pts.shape[1]
    mll_at(post, pts)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    m, g = grad_at(post, pts)
    torch.cuda.synchronize()
    t_grad = time.time() - t0
    one = dict(kernels.launches)
    add(one)
    for k in KERNELS:
        want = 1 if k in PATH_KERNELS["flagship_grad"] else 0
        require(one[k] == want, f"one flagship gradient launches {k} {want} time(s)")
    require(bool(np.isfinite(g).all()), "the flagship gradient is finite")
    # b. central differences, no halofit
    h = GRAD_FD_STEP * np.array([p.propose_width for p in post.space.varying])

    def differences(p_):
        out = mll_at(p_, np.concatenate([x + s * np.diag(h) for x in pts
                                         for s in (1.0, -1.0)]))
        return np.stack([(out[2 * i * n:(2 * i + 1) * n]
                          - out[(2 * i + 1) * n:(2 * i + 2) * n]) / (2.0 * h)
                         for i in range(len(pts))])
    lin = flagship_grad_posterior(dev, fid["ds"], fid["dr12"], nonlinear=False)
    kernels.reset_launches()
    _, gl = grad_at(lin, pts)
    add(kernels.launches)
    t0 = time.time()
    fd = differences(lin)
    t_fd = time.time() - t0
    e_fd = float((np.abs(fd - gl).max(1) / np.abs(gl).max(1)).max())
    fd_nl = differences(post)
    e_nl = np.abs(fd_nl - g).max(1) / np.abs(g).max(1)
    # the same at larger steps: at 1e-6 widths the differences carry
    # -logL's float64 rounding (~1e-11 absolute here) over 2 h, which falls
    # as the step grows, until the kinks of the piecewise-smooth -logL
    # (K2a's table interpolation in x, the grids that move with the
    # parameters) come within a step
    h0, e_h = h, {}
    for f in FLAG_FD_STEPS:
        h = f * h0 / GRAD_FD_STEP
        e_h[f] = float((np.abs(differences(lin) - gl).max(1) / np.abs(gl).max(1)).max())
    h = h0
    log(f"phase 15: -logL {m} at the best fit and off it; the gradient of both "
        f"in {t_grad:.2f} s ({n} parameters, float64, halofit lensing); "
        f"central differences (step {GRAD_FD_STEP} x the proposal widths, "
        f"{2 * n * len(pts)} points a batch, {t_fd:.2f} s) against the gradient "
        f"without halofit: max |fd - grad| / max |grad| {e_fd:.3e} (tol "
        f"{GRAD_FD_TOL}); at larger steps " + ", ".join(
            f"{f} widths {e:.3e}" for f, e in e_h.items())
        + f"; with halofit {e_nl} (k_sigma's bisection carries no "
        f"derivative, as in JAX)")
    for j in range(len(pts)):
        for i in np.argsort(-np.abs(fd[j] - gl[j]))[:3]:
            log(f"  [{j}] d(-logL)/d{names[i]:10s} no halofit {gl[j, i]: .9e} "
                f"fd {fd[j, i]: .9e}; halofit {g[j, i]: .9e} fd {fd_nl[j, i]: .9e}")
    require(e_fd <= GRAD_FD_TOL, "the flagship gradient agrees with finite differences")
    # c. the small config against the host CPU's plain gradient
    with open(os.path.join(jobdir, "flag.json")) as f:
        small_ds = json.load(f)["ds"]
    small = flagship_grad_posterior(dev, small_ds, nonlinear=False, cfg=FLAG_SMALL)
    kernels.reset_launches()
    m_s, g_s = grad_at(small, flagship_grad_points(small))
    add(kernels.launches)
    ref = finish_job(cpu_job, jobdir, "cpu_grad_cmb.pt",
                     "the CPU plain flagship gradient")
    g_cpu, m_cpu = ref["g"].numpy(), ref["mll"].numpy()
    e_cpu = float((np.abs(g_s - g_cpu).max(1) / np.abs(g_cpu).max(1)).max())
    log(f"  at {FLAG_SMALL}: -logL {m_s} on the card, {m_cpu} on the host CPU's "
        f"plain versions ({ref['seconds']:.1f} s there); gradients max rel "
        f"{e_cpu:.3e} (tol {GRAD_CPU_TOL})")
    require(e_cpu <= GRAD_CPU_TOL, "the card's flagship gradient equals the CPU's")
    P8 = torch.as_tensor(post.start_positions(np.random.default_rng(0), NCHAINS),
                         dtype=F64, device=dev).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.time()
    torch.autograd.grad(post.logpost()(P8)[0].sum(), P8)
    torch.cuda.synchronize()
    t8 = time.time() - t0
    add(kernels.launches)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  one HMC gradient at {NCHAINS} chains: {t8:.2f} s, peak memory "
        f"{peak / 2 ** 20:.1f} MiB ({peak / 2 ** 20 / NCHAINS:.1f} MiB a chain, "
        f"float64, {GRAD_CHUNKS} K1 chunks)")

    # d. HMC through the CLI
    out, err = hmc_proc.communicate(timeout=JOB_TIMEOUT)
    t_hmc = time.time() - hmc_proc.t0
    for line in (out + err).strip().splitlines()[-8:]:
        log(f"  | {line}")
    require(hmc_proc.returncode == 0, "the flagship HMC CLI exits 0")
    acc = float(out.split("accept =")[1].split(",")[0])
    hmc = MCSamples.load(os.path.join(d_root(tmp), "chains", "hmc"), ignore_frac=0.0)
    log(f"  HMC (CLI, {FLAG_HMC}): acceptance {acc:.3f}, {hmc.samples.shape[0]} "
        f"rows, {t_hmc:.1f} s from start (beside phases 6-14)")
    require(0.0 < acc <= 1.0, "the flagship HMC accepts")
    require(hmc.samples.shape[0] > 0 and bool(np.isfinite(hmc.samples).all()),
            "MCSamples loads finite flagship HMC chains")

    # e. action 2, in-process, the refine cut short
    ini, _ = flagship_ini(tmp, fid, {"action": "2", "file_root": os.path.join(
        d_root(tmp), "chains", "min")})
    real = minimize.find_best_fit
    kernels.reset_launches()
    t0 = time.time()
    try:
        minimize.find_best_fit = lambda *a, **k: real(
            *a, **{**k, "refine_steps": GRAD_MIN_REFINE, "refine_chains": 8,
                   "maxiter": GRAD_MIN_ITER})
        with contextlib.redirect_stdout(io.StringIO()):
            rc = driver.run_ini(ini)
    finally:
        minimize.find_best_fit = real
    t_min = time.time() - t0
    run2 = dict(kernels.launches)
    add(run2)
    root2 = os.path.join(d_root(tmp), "chains", "min")
    with open(root2 + ".minimum") as f:
        mll_min = float(f.read().split("-log(Like) =")[1].split()[0])
    cov = np.loadtxt(root2 + ".hessian.covmat")
    ev = np.linalg.eigvalsh(0.5 * (cov + cov.T))
    mll_c = float(mll_at(driver.build_posterior(IniFile(ini)), pts[:1])[0])
    log(f"  action 2: -logL {mll_c:.6f} at the best fit -> {mll_min:.6f} in "
        f"{t_min:.1f} s; Hessian covmat eigenvalues {ev.min():.3e} .. "
        f"{ev.max():.3e}; launches " + json.dumps({k: v for k, v in run2.items() if v}))
    require(rc == 0 and mll_min <= mll_c + 1e-9, ".minimum at or below the best fit")
    require(np.allclose(cov, cov.T, rtol=1e-10, atol=0.0) and bool((ev > 0).all()),
            "the Hessian covmat is symmetric positive definite")
    for k in KERNELS:
        require((run2[k] > 0) == (k in PATH_KERNELS["flagship_grad"]),
                f"action 2 launches {k} only if on the flagship gradient path")

    log(f"phase 15 took {time.time() - t_phase:.1f} s on {smi_line()}")
    return launches, one


def ext_grad_posterior(dev, label, ds, dr12, nonlinear=True, cfg=None):
    """Phase 16's posterior: phase 9's ("mnu") or phase 10's ("w0wa", with
    alpha1 free) configuration in float64 on the plik_lite set `ds` and
    the DR12 set with f_sigma8 rows `dr12`, the tau prior, matter power, K1
    checkpointed in GRAD_CHUNKS chunks."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(ds, name="plik_lite", device=dev, dtype=F64))
    if dr12:
        likes.add(BAOLikelihood(dr12, name="DR12", device=dev, dtype=F64))
    return ext_posterior(dev, label, likes, F64, alpha1=EXT_GRAD[label]["alpha1"],
                         nonlinear_lens=nonlinear, remat_chunks=GRAD_CHUNKS,
                         **(cfg or {}))


def ext_grad_points(post, label):
    """Phase 16's points: BESTFIT at EXT_POINT[label] (alpha1 0.05 where it
    is free: the amplitude map sign(a) sqrt(|a| / (1 - |a|)) has no
    derivative at 0), and it + 0.3 proposal widths along a seeded normal
    draw."""
    at = dict(EXT_POINT[label], **({"alpha1": 0.05} if EXT_GRAD[label]["alpha1"]
                                   else {}))
    c = bestfit_vector(post, at)
    w = np.array([p.propose_width for p in post.space.varying])
    return np.stack([c, c + 0.3 * w * np.random.default_rng(16).standard_normal(
        len(c))])


def ext_small_sets(dev, d, ds):
    """Phase 16 (c)'s sets, written before the host CPU's jobs start: the
    smooth plik_lite fiducial `ds` and, for each EXT_GRAD configuration, a
    DR12 set with f_sigma8 rows written from the card's float64 theory at
    its first point at FLAG_SMALL on the reduced matter grid; d/<label>/
    ext.json names them. Returns those directories."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.synthetic import write_dr12_bao
    dirs = {}
    for label in EXT_GRAD:
        p0 = ext_posterior(dev, label, LikelihoodList(), F64,
                           alpha1=EXT_GRAD[label]["alpha1"], nonlinear_lens=False,
                           **FLAG_SMALL)
        full = p0.embed_full(torch.as_tensor(ext_grad_points(p0, label)[:1],
                                             dtype=F64, device=dev))
        with reduced_matter_grid(), torch.no_grad():
            slow = p0.stage_slow(full)
            theory = p0.assemble_theory(slow, p0.stage_semi(full, slow))
        dirs[label] = dd = os.path.join(d, label)
        bao0 = BAOLikelihood(write_dr12_bao(os.path.join(dd, "dr12"), fsigma8=True),
                             device=dev, dtype=F64)
        dr12 = write_dr12_bao(os.path.join(dd, "dr12"),
                              bao0.theory_vector(theory)[0].cpu().numpy(),
                              fsigma8=True)
        with open(os.path.join(dd, "ext.json"), "w") as f:
            json.dump(dict(label=label, ds=ds, dr12=dr12), f)
    return dirs


def cpu_gradient_ext(d):
    """--cpu-grad-ext DIR: the float64 gradient of phase 16's -logL for the
    EXT_GRAD configuration named in DIR/ext.json at its first point on the
    host CPU (the plain versions under autograd) at FLAG_SMALL on the
    reduced matter grid, on the sets named there; writes
    DIR/cpu_grad_ext.pt."""
    torch.set_num_threads(JOB_THREADS["--cpu-grad-ext"])
    with open(os.path.join(d, "ext.json")) as f:
        sets = json.load(f)
    label = sets["label"]
    post = ext_grad_posterior(torch.device("cpu"), label, sets["ds"], sets["dr12"],
                              nonlinear=False, cfg=FLAG_SMALL)
    t0 = time.time()
    with reduced_matter_grid():
        m, g = grad_at(post, ext_grad_points(post, label)[:1])
    out = dict(mll=torch.as_tensor(m), g=torch.as_tensor(g), seconds=time.time() - t0)
    print(f"{label} gradient on the CPU in {out['seconds']:.1f} s", flush=True)
    torch.save(out, os.path.join(d, "cpu_grad_ext.pt"))
    return 0


def ext_ini(tmp, sets, label, extra):
    """Phase 9's or 10's configuration as an ini (plik_lite and the DR12 set
    with f_sigma8 rows of `sets`, the tau prior, matter power,
    EXT_FREE[label]), float64, with `extra` keys."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    d = os.path.join(tmp, "ext_grad")
    os.makedirs(d, exist_ok=True)
    bbn = os.path.join(d, "bbn_grid.dat")
    if not os.path.exists(bbn):
        sd.write_bbn_table(bbn)
    keys = {"pliklite_dataset": sets["ds"], "bao_dataset[DR12]": sets["dr12"],
            "prior[tau]": "0.0544 0.0073", "bbn_table": bbn,
            "use_matter_power": "T", "use_float64": "T", "feedback": "0",
            **{f"param[{n}]": v for n, v in EXT_FREE[label].items()}, **extra}
    return write_ini(os.path.join(d, f"{label}_{len(os.listdir(d))}.ini"),
                     keys), d


def start_ext_hmc(tmp, sets):
    """Phase 16 (d), started before phase 13 (after phase 2's timings of
    the extended reverse kernels, which it would share the card with) so
    that it runs beside phases 13-15: `python -m cosmomc_tpu_torch` on the
    base_mnu ini with sampling_method = hmc (EXT_HMC)."""
    ini, d = ext_ini(tmp, sets, "mnu", {
        "action": "0", "sampling_method": "hmc", "MPI_R_Stop": "0",
        "file_root": os.path.join(tmp, "ext_grad", "chains", "hmc"),
        **{k: str(v) for k, v in EXT_HMC.items()}})
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "cosmomc_tpu_torch", ini],
                            cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.t0 = time.time()
    return proc


def ext_min_job(d):
    """--ext-min DIR: phase 16 (e) in a process of its own on the card,
    beside phases 14 and 15: action = 2 of the driver on the base_w_wa ini that
    DIR/min.json names, the minimizer cut as in phase 14; writes DIR/min.pt
    (the exit code, the seconds and the kernel launches of the run)."""
    from cosmomc_tpu_torch import driver, kernels
    from cosmomc_tpu_torch.sampling import minimize
    with open(os.path.join(d, "min.json")) as f:
        ini = json.load(f)["ini"]
    real = minimize.find_best_fit
    minimize.find_best_fit = lambda *a, **k: real(
        *a, **{**k, "refine_steps": GRAD_MIN_REFINE, "refine_chains": 8,
               "maxiter": GRAD_MIN_ITER})
    kernels.reset_launches()
    t0 = time.time()
    rc = driver.run_ini(ini)
    torch.save(dict(rc=rc, seconds=time.time() - t0,
                    launches=dict(kernels.launches)), os.path.join(d, "min.pt"))
    return 0


def start_ext_min(tmp, sets):
    """Phase 16 (e), started after phase 13 so that it runs beside phases
    14 and 15: `ext_min_job` on the base_w_wa ini (w and wa free). Returns
    the process and its directory."""
    ini, d = ext_ini(tmp, sets, "w0wa", {
        "action": "2", "file_root": os.path.join(tmp, "ext_grad", "chains", "min")})
    with open(os.path.join(d, "min.json"), "w") as f:
        json.dump(dict(ini=ini), f)
    return start_job("--ext-min", d), d


def drive_ext_gradient(dev, tmp, ext_sets, cpu_jobs, hmc_proc, min_job):
    """Phase 16: the gradients of base_mnu ("mnu", K1's massive-neutrino
    instantiation) and of base_w_wa with alpha1 free ("w0wa", the DE fluid
    with CDM isocurvature), full width, float64, on phases 9's and 10's
    plik_lite fiducial and DR12 set with f_sigma8 rows, the tau prior,
    matter power. For each:
      a. torch.autograd.grad of -logL (nonlinear_lens=False: halofit's
         k_sigma bisection carries no derivative, in either package) at its
         two points (`ext_grad_points`): K4, K2a, K3 and their reverse
         kernels once, the path's K1 instantiation and its reverse kernel
         twice (the source and the matter grids), nothing else;
      b. against central differences of -logL (one batch a step) at each
         point within GRAD_FD_TOL of the largest component, at the closer
         of EXT_FD_STEPS;
      c. at FLAG_SMALL on the reduced matter grid, on the sets of
         `ext_small_sets`, against the host CPU's plain gradient
         (`--cpu-grad-ext`, one process a configuration: `cpu_jobs`, label
         -> (process, directory)) within GRAD_CPU_TOL; the seconds and the
         peak memory a chain of one HMC gradient at NCHAINS chains with
         halofit lensing, as users run it.
    Then:
      d. `python -m cosmomc_tpu_torch` with sampling_method = hmc on the
         base_mnu ini (EXT_HMC, started before phase 13): exit 0, its
         acceptance, chains that MCSamples loads;
      e. action = 2 on the base_w_wa ini (w and wa free; `min_job`: the
         process and directory of `start_ext_min`, the minimizer cut as in
         phase 14): the .minimum at or below -logL at the centre it starts
         from, a symmetric positive definite .hessian.covmat, only the
         w0wa path's kernels launched.
    Returns the launches of (a)-(e) and of one gradient, by path."""
    from cosmomc_tpu_torch import driver, kernels
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
    from cosmomc_tpu_torch.utils.ini import IniFile

    t_phase = time.time()
    launches = {p: {k: 0 for k in kernels.launches} for p in EXT_GRAD}
    one_grad = {}

    def add(label, counts):
        for k, v in counts.items():
            launches[label][k] += v
    for label in EXT_GRAD:
        path = f"{label}_grad"
        k1, k1b = PATH_KERNELS[path][1], PATH_KERNELS[path][5]
        # a. the gradient (no halofit: its k_sigma bisection carries no
        # derivative, so (b) could not hold it)
        lin = ext_grad_posterior(dev, label, ext_sets[label]["ds"],
                                 ext_sets[label]["dr12"], nonlinear=False)
        names = [p.name for p in lin.space.varying]
        pts = ext_grad_points(lin, label)
        n = pts.shape[1]
        mll_at(lin, pts)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        m, gl = grad_at(lin, pts)
        torch.cuda.synchronize()
        t_grad = time.time() - t0
        one = dict(kernels.launches)
        one_grad[path] = one
        add(label, one)
        for k in KERNELS:
            want = (2 if k in (k1, k1b) else 1) if k in PATH_KERNELS[path] else 0
            require(one[k] == want, f"{path}: one gradient launches {k} {want} time(s)")
        require(bool(np.isfinite(gl).all()), f"{path}: the gradient is finite")
        # b. central differences
        w = np.array([p.propose_width for p in lin.space.varying])

        def differences(p_, h):
            out = mll_at(p_, np.concatenate([x + s * np.diag(h) for x in pts
                                             for s in (1.0, -1.0)]))
            return np.stack([(out[2 * i * n:(2 * i + 1) * n]
                              - out[(2 * i + 1) * n:(2 * i + 2) * n]) / (2.0 * h)
                             for i in range(len(pts))])
        t0 = time.time()
        fds = {f: differences(lin, f * w) for f in EXT_FD_STEPS}
        t_fd = time.time() - t0
        err = {f: np.abs(fd - gl).max(1) / np.abs(gl).max(1) for f, fd in fds.items()}
        e_fd = float(np.min(np.stack(list(err.values())), 0).max())
        log(f"phase 16 ({path}): -logL {m} at the point and off it; the gradient "
            f"of both in {t_grad:.2f} s ({n} parameters, float64, no halofit); "
            f"central differences ({2 * n * len(pts)} points a batch, "
            f"{len(fds)} batches in {t_fd:.2f} s), max |fd - grad| / max |grad| "
            f"at each point: " + ", ".join(
                f"{f} widths {e}" for f, e in err.items())
            + f"; the closer step's {e_fd:.3e} (tol {GRAD_FD_TOL})")
        fd = fds[GRAD_FD_STEP]
        for j in range(len(pts)):
            for i in np.argsort(-np.abs(fd[j] - gl[j]))[:3]:
                log(f"  [{j}] d(-logL)/d{names[i]:10s} {gl[j, i]: .9e} fd "
                    + " ".join(f"{fds[f][j, i]: .9e}" for f in EXT_FD_STEPS))
        require(e_fd <= GRAD_FD_TOL, f"{path}: the gradient agrees with finite "
                "differences")
        # c. the small config against the host CPU's plain gradient
        job, jobdir = cpu_jobs[label]
        with open(os.path.join(jobdir, "ext.json")) as f:
            small_sets = json.load(f)
        small = ext_grad_posterior(dev, label, small_sets["ds"], small_sets["dr12"],
                                   nonlinear=False, cfg=FLAG_SMALL)
        kernels.reset_launches()
        with reduced_matter_grid():
            m_s, g_s = grad_at(small, ext_grad_points(small, label)[:1])
        add(label, kernels.launches)
        ref = finish_job(job, jobdir, "cpu_grad_ext.pt",
                         f"the CPU plain {path} gradient")
        g_cpu, m_cpu = ref["g"].numpy(), ref["mll"].numpy()
        e_cpu = float((np.abs(g_s - g_cpu).max(1) / np.abs(g_cpu).max(1)).max())
        log(f"  at {FLAG_SMALL} (matter grid {CPU_GRAD_MATTER}, {CPU_GRAD_STEPS} "
            f"steps): -logL {m_s} on the card, {m_cpu} on the host CPU's plain "
            f"versions ({ref['seconds']:.1f} s there); gradients max rel "
            f"{e_cpu:.3e} (tol {GRAD_CPU_TOL})")
        require(e_cpu <= GRAD_CPU_TOL, f"{path}: the card's gradient equals the CPU's")
        # the users' configuration (halofit lensing) at HMC's width
        post = ext_grad_posterior(dev, label, ext_sets[label]["ds"],
                                  ext_sets[label]["dr12"])
        P8 = torch.as_tensor(post.start_positions(np.random.default_rng(0), NCHAINS),
                             dtype=F64, device=dev)
        if EXT_GRAD[label]["alpha1"]:
            P8[:, names.index("alpha1")] = 0.05
        P8.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launches()
        t0 = time.time()
        torch.autograd.grad(post.logpost()(P8)[0].sum(), P8)
        torch.cuda.synchronize()
        t8 = time.time() - t0
        add(label, kernels.launches)
        peak = torch.cuda.max_memory_allocated() - base
        log(f"  one HMC gradient at {NCHAINS} chains: {t8:.2f} s, peak memory "
            f"{peak / 2 ** 20:.1f} MiB ({peak / 2 ** 20 / NCHAINS:.1f} MiB a chain, "
            f"float64, {GRAD_CHUNKS} K1 chunks)")

    # d. HMC through the CLI on base_mnu
    out, err_ = hmc_proc.communicate(timeout=JOB_TIMEOUT)
    t_hmc = time.time() - hmc_proc.t0
    for line in (out + err_).strip().splitlines()[-8:]:
        log(f"  | {line}")
    require(hmc_proc.returncode == 0, "the base_mnu HMC CLI exits 0")
    acc = float(out.split("accept =")[1].split(",")[0])
    hmc = MCSamples.load(os.path.join(tmp, "ext_grad", "chains", "hmc"),
                         ignore_frac=0.0)
    log(f"  HMC on base_mnu (CLI, {EXT_HMC}): acceptance {acc:.3f}, "
        f"{hmc.samples.shape[0]} rows, {t_hmc:.1f} s from start (beside phases "
        f"13-16)")
    require(0.0 < acc <= 1.0, "the base_mnu HMC accepts")
    require(hmc.samples.shape[0] > 0 and bool(np.isfinite(hmc.samples).all()),
            "MCSamples loads finite base_mnu HMC chains")
    require("mnu" in [i.name for i in hmc.names.names],
            "the base_mnu HMC chains sample mnu")

    # e. action 2 on base_w_wa, in a process of its own, the refine cut short
    job, d = min_job
    res = finish_job(job, d, "min.pt", "action 2 on the base_w_wa ini")
    with open(os.path.join(d, "min.json")) as f:
        ini = json.load(f)["ini"]
    rc, t_min, run2 = res["rc"], res["seconds"], res["launches"]
    add("w0wa", run2)
    root2 = os.path.join(tmp, "ext_grad", "chains", "min")
    with open(root2 + ".minimum") as f:
        mll_min = float(f.read().split("-log(Like) =")[1].split()[0])
    cov = np.loadtxt(root2 + ".hessian.covmat")
    ev = np.linalg.eigvalsh(0.5 * (cov + cov.T))
    p2 = driver.build_posterior(IniFile(ini))
    require(p2.de_perturbations and not p2.massive_nu_hierarchy,
            "the base_w_wa ini switches the DE fluid on")
    mll_c = float(mll_at(p2, np.array([[p.center for p in p2.space.varying]]))[0])
    log(f"  action 2 on base_w_wa: -logL {mll_c:.6f} at the centre -> {mll_min:.6f} "
        f"in {t_min:.1f} s; Hessian covmat eigenvalues {ev.min():.3e} .. "
        f"{ev.max():.3e}; launches " + json.dumps({k: v for k, v in run2.items() if v}))
    require(rc == 0 and mll_min <= mll_c + 1e-9, ".minimum at or below the centre")
    require(np.allclose(cov, cov.T, rtol=1e-10, atol=0.0) and bool((ev > 0).all()),
            "the base_w_wa Hessian covmat is symmetric positive definite")
    for k in KERNELS:
        require((run2[k] > 0) == (k in PATH_KERNELS["w0wa_grad"]),
                f"action 2 on base_w_wa launches {k} only if on its gradient path")
    log(f"phase 16 took {time.time() - t_phase:.1f} s on {smi_line()}")
    return ({f"{p}_grad": launches[p] for p in EXT_GRAD}, one_grad)


def lcdm_r_posterior(dev, ds, nonlinear=True, cfg=None):
    """LCDM+r on the flagship's likelihoods (plik_lite + the tau prior):
    `flagship_grad_posterior` with compute_tensors=True (r free, semi-slow,
    nt = -r/8), float64, K1 and K5 checkpointed in GRAD_CHUNKS chunks."""
    return flagship_grad_posterior(dev, ds, nonlinear=nonlinear,
                                   cfg=dict(cfg or {}, compute_tensors=True))


def lcdm_r_tau0(post, P):
    """tau0 of `post`'s slow path at the points P (float64 numpy)."""
    from cosmomc_tpu_torch.models.bbn import yhe_bbn
    from cosmomc_tpu_torch.models.perturbations import build_thermo_funcs
    from cosmomc_tpu_torch.models.recfast import compute_thermo
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    with torch.no_grad():
        full = post.embed_full(torch.as_tensor(P, dtype=F64, device=post.device))
        bg = post.parameterization.to_background(full)
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, post.bbn_table)
        zre = zre_from_tau(bg, full[:, post._i_tau], yhe)
        _, tau0 = build_thermo_funcs(bg, yhe, compute_thermo(bg, yhe), zre,
                                     n_step=post.n_step_boltzmann, kmax=post.kmax)
    return tau0.double().cpu().numpy()


def cpu_gradient_lcdm_r(d):
    """--cpu-grad-lcdm-r DIR: the float64 gradient of LCDM+r's -logL at
    phase 17's two points on the host CPU (the plain versions under
    autograd) at FLAG_SMALL without halofit, on the plik_lite set named in
    DIR/flag.json, and tau0 there; writes DIR/cpu_grad_lcdm_r.pt."""
    torch.set_num_threads(JOB_THREADS["--cpu-grad-lcdm-r"])
    with open(os.path.join(d, "flag.json")) as f:
        ds = json.load(f)["ds"]
    post = lcdm_r_posterior(torch.device("cpu"), ds, nonlinear=False, cfg=FLAG_SMALL)
    pts = flagship_grad_points(post)
    t0 = time.time()
    m, g = grad_at(post, pts)
    out = dict(mll=torch.as_tensor(m), g=torch.as_tensor(g),
               tau0=torch.as_tensor(lcdm_r_tau0(post, pts)),
               seconds=time.time() - t0)
    print(f"LCDM+r gradient on the CPU in {out['seconds']:.1f} s", flush=True)
    torch.save(out, os.path.join(d, "cpu_grad_lcdm_r.pt"))
    return 0


def lcdm_r_hmc_job(d):
    """--lcdm-r-hmc DIR: phase 17 (d) in a process of its own on the card:
    the CLI's entry (`cosmomc_tpu_torch.driver.main`, what `python -m
    cosmomc_tpu_torch` runs) on the LCDM+r ini that DIR/hmc.json names,
    sampling_method = hmc; writes DIR/hmc.pt (the exit code, the seconds,
    what it printed and the kernel launches of the run)."""
    from cosmomc_tpu_torch import driver, kernels
    with open(os.path.join(d, "hmc.json")) as f:
        ini = json.load(f)["ini"]
    kernels.reset_launches()
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.main([ini])
    print(buf.getvalue(), flush=True)
    torch.save(dict(rc=rc, seconds=time.time() - t0, out=buf.getvalue(),
                    launches=dict(kernels.launches)), os.path.join(d, "hmc.pt"))
    return 0


def start_lcdm_r_hmc(tmp, fid):
    """Phase 17 (d), started after phase 13 so that it runs beside phases
    14-16: `lcdm_r_hmc_job` on the flagship ini with LCDMR_FREE (LCDMR_HMC).
    Returns the process and its directory."""
    ini, d = flagship_ini(tmp, fid, {
        **LCDMR_FREE, "action": "0",
        "sampling_method": "hmc", "MPI_R_Stop": "0",
        "file_root": os.path.join(d_root(tmp), "chains", "lcdm_r_hmc"),
        **{k: str(v) for k, v in LCDMR_HMC.items()}})
    with open(os.path.join(d, "hmc.json"), "w") as f:
        json.dump(dict(ini=ini), f)
    return start_job("--lcdm-r-hmc", d), d


def drive_lcdm_r_gradient(dev, tmp, fid, cpu_job, jobdir, hmc_job):
    """Phase 17: LCDM+r's gradient at full width in float64 (K4, K1, K2a,
    K3, K5, K6 forward and their six reverse kernels) on phase 3's
    plik_lite fiducial and the tau prior, r free:
      a. torch.autograd.grad of -logL (halofit lensing) at the best fit with
         r = 0.1 and off it: exactly one launch of each of the path's twelve
         kernels; the seconds and the peak memory a chain of one HMC
         gradient at NCHAINS chains;
      b. with nonlinear_lens=False against central differences of -logL
         (one batch a step) within GRAD_FD_TOL of the largest component, at
         each point the closer of LCDMR_FD_STEPS;
      c. at FLAG_SMALL on the smooth plik_lite fiducial against the host
         CPU's plain gradient (`--cpu-grad-lcdm-r`, started before phase 3)
         within GRAD_CPU_TOL, with both tau0 and their gap in ulps printed;
      d. the CLI's HMC on the LCDM+r ini (`--lcdm-r-hmc`, started after
         phase 13; `hmc_job`: its process and directory): exit 0, its
         acceptance, tensors_bwd and tensor_los_bwd among its launches,
         chains that MCSamples loads;
      e. CMBPosterior with los_method="recurrence" (K2b, no reverse kernel)
         raises NotImplementedError for a gradient before any launch.
    Returns the launches of (a)-(c) and (e), and of one gradient."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples

    t_phase = time.time()
    launches = {k: 0 for k in kernels.launches}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
    # a. the gradient, halofit lensing
    post = lcdm_r_posterior(dev, fid["ds"])
    names = [p.name for p in post.space.varying]
    require("r" in names, "r is free on LCDM+r")
    pts = flagship_grad_points(post)
    n = pts.shape[1]
    mll_at(post, pts)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.time()
    m, g = grad_at(post, pts)
    torch.cuda.synchronize()
    t_grad = time.time() - t0
    one = dict(kernels.launches)
    add(one)
    for k in KERNELS:
        want = 1 if k in PATH_KERNELS["lcdm_r_grad"] else 0
        require(one[k] == want, f"one LCDM+r gradient launches {k} {want} time(s)")
    require(bool(np.isfinite(g).all()), "the LCDM+r gradient is finite")
    require(bool((g[:, names.index("r")] != 0).all()), "d(-logL)/dr is not 0")
    P8 = torch.as_tensor(post.start_positions(np.random.default_rng(0), NCHAINS),
                         dtype=F64, device=dev).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.time()
    torch.autograd.grad(post.logpost()(P8)[0].sum(), P8)
    torch.cuda.synchronize()
    t8 = time.time() - t0
    add(kernels.launches)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"phase 17: -logL {m} at the best fit (r = {BESTFIT['r']}) and off it; "
        f"the gradient of both in {t_grad:.2f} s ({n} parameters, float64, "
        f"halofit lensing); one HMC gradient at {NCHAINS} chains {t8:.2f} s, peak "
        f"memory {peak / 2 ** 20:.1f} MiB ({peak / 2 ** 20 / NCHAINS:.1f} MiB a "
        f"chain, {GRAD_CHUNKS} K1 and K5 chunks)")
    del P8
    # b. central differences, no halofit
    lin = lcdm_r_posterior(dev, fid["ds"], nonlinear=False)
    kernels.reset_launches()
    _, gl = grad_at(lin, pts)
    add(kernels.launches)
    w = np.array([p.propose_width for p in lin.space.varying])
    errs = {}
    for f in LCDMR_FD_STEPS:
        h = f * w
        out = mll_at(lin, np.concatenate([x + s * np.diag(h) for x in pts
                                          for s in (1.0, -1.0)]))
        fd = np.stack([(out[2 * i * n:(2 * i + 1) * n]
                        - out[(2 * i + 1) * n:(2 * i + 2) * n]) / (2.0 * h)
                       for i in range(len(pts))])
        errs[f] = np.abs(fd - gl).max(1) / np.abs(gl).max(1)
        for j in range(len(pts)):
            i = int(np.argmax(np.abs(fd[j] - gl[j])))
            log(f"  [{j}] at {f} widths: max |fd - grad| / max |grad| "
                f"{errs[f][j]:.3e}, along {names[i]}: grad {gl[j, i]: .9e} fd "
                f"{fd[j, i]: .9e}")
    e_fd = float(np.min(np.stack(list(errs.values())), 0).max())
    log(f"  central differences without halofit, the closer of "
        f"{LCDMR_FD_STEPS} widths at each point: {e_fd:.3e} (tol {GRAD_FD_TOL})")
    require(e_fd <= GRAD_FD_TOL, "the LCDM+r gradient agrees with finite differences")
    # c. the small config against the host CPU's plain gradient
    with open(os.path.join(jobdir, "flag.json")) as f:
        small_ds = json.load(f)["ds"]
    small = lcdm_r_posterior(dev, small_ds, nonlinear=False, cfg=FLAG_SMALL)
    spts = flagship_grad_points(small)
    kernels.reset_launches()
    m_s, g_s = grad_at(small, spts)
    add(kernels.launches)
    tau0_card = lcdm_r_tau0(small, spts)
    ref = finish_job(cpu_job, jobdir, "cpu_grad_lcdm_r.pt",
                     "the CPU plain LCDM+r gradient")
    g_cpu, m_cpu, tau0_cpu = ref["g"].numpy(), ref["mll"].numpy(), ref["tau0"].numpy()
    e_cpu = float((np.abs(g_s - g_cpu).max(1) / np.abs(g_cpu).max(1)).max())
    ulps = (tau0_card - tau0_cpu) / np.spacing(tau0_cpu)
    log(f"  at {FLAG_SMALL}: -logL {m_s} on the card, {m_cpu} on the host CPU's "
        f"plain versions ({ref['seconds']:.1f} s there); tau0 {tau0_card.tolist()} "
        f"on the card, {tau0_cpu.tolist()} on the host CPU ({ulps.tolist()} ulps); "
        f"gradients max rel {e_cpu:.3e} (tol {GRAD_CPU_TOL})")
    require(e_cpu <= GRAD_CPU_TOL, "the card's LCDM+r gradient equals the CPU's")
    del small, lin
    torch.cuda.empty_cache()
    # d. HMC through the CLI
    proc, hdir = hmc_job
    res = finish_job(proc, hdir, "hmc.pt", "the LCDM+r HMC CLI")
    require(res["rc"] == 0, "the LCDM+r HMC CLI exits 0")
    acc = float(res["out"].split("accept =")[1].split(",")[0])
    hmc = MCSamples.load(os.path.join(d_root(tmp), "chains", "lcdm_r_hmc"),
                         ignore_frac=0.0)
    log(f"  HMC (CLI, {LCDMR_HMC}): acceptance {acc:.3f}, {hmc.samples.shape[0]} "
        f"rows, {res['seconds']:.1f} s; launches "
        + json.dumps({k: v for k, v in res["launches"].items() if v}))
    require(0.0 < acc <= 1.0, "the LCDM+r HMC accepts")
    require(res["launches"]["tensors_bwd"] > 0 and res["launches"]["tensor_los_bwd"] > 0,
            "the LCDM+r HMC launches tensors_bwd and tensor_los_bwd")
    for k in KERNELS:
        require((res["launches"][k] > 0) == (k in PATH_KERNELS["lcdm_r_grad"]),
                f"the LCDM+r HMC launches {k} only if on the LCDM+r gradient path")
    require(hmc.samples.shape[0] > 0 and bool(np.isfinite(hmc.samples).all()),
            "MCSamples loads finite LCDM+r HMC chains")
    # e. the recurrence line of sight refuses before any launch
    rec = lcdm_r_posterior(dev, fid["ds"], cfg=dict(los_method="recurrence"))
    require(rec.gradient_unsupported() == "los_method = recurrence (K2b)",
            "the recurrence line of sight names K2b")
    kernels.reset_launches()
    try:
        grad_at(rec, pts[:1])
        raised = False
    except NotImplementedError as e:
        raised = "queue 1 item 4" in str(e)
    require(raised and not any(kernels.launches.values()),
            "a gradient with los_method=recurrence raises before any launch")
    log("  los_method=recurrence raises for a gradient before any launch")
    log(f"phase 17 took {time.time() - t_phase:.1f} s on {smi_line()}")
    return launches, one


def kernel_of(line):
    """The kernel and template arguments of a ptxas "Compiling entry
    function" line: _ZN<len><namespace><len><fn>I{f,d}[Li<NPT>E][Lb<0|1>E
    ...]E...: f float, d double; K1's bool flags are NU, DE, K5's forward's
    CK (the checkpoint stores)."""
    mangled = line.split("'")[1] if "'" in line else "?"
    m = re.search(r"_ZN(\d+)", line)
    n = m and re.match(r"\d+", line[m.end() + int(m.group(1)):])
    if not n:
        return mangled
    i = m.end() + int(m.group(1))
    name = line[i + n.end():i + n.end() + int(n.group())]
    t = re.match(r"I([fd])(?:Li(\d+)E)?((?:Lb[01]E)*)",
                 line[i + n.end() + int(n.group()):])
    if not t:
        return name
    flags = re.findall(r"Lb([01])E", t.group(3))
    names = ("CK",) if name == "tensor_kernel" else ("NU", "DE")
    return (f"{name} {'f64' if t.group(1) == 'd' else 'f32'}"
            + (f" NPT={t.group(2)}" if t.group(2) else "")
            + "".join(f" {k}={f}" for k, f in zip(names, flags)))


def phase2_job(d):
    """--phase2 DIR: phase 2's checks of the kernels and reverse kernels
    but K1's extended instantiations (phase2, phase2_matter,
    phase2_reverse, phase2_reverse_cmb, phase2_reverse_tensors), in a
    process of its own on the card beside the main one's phases 3-17: their
    plain versions are Python loops bound by their launches on the host. It
    starts the host-CPU plain references they read (`--plain-ref`,
    `--plain-ref-cmb`, `--plain-ref-tensors`) and stops them if it fails;
    writes DIR/phase2.json (each kernel's entry of the kernels line)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    results, jobs = {}, []
    try:
        reverse_inputs(dev, d)
        ten = tensor_reverse_inputs(dev, d)
        jobs.append(start_job("--plain-ref", d))
        jobs.append(start_job("--plain-ref-cmb", d))
        jobs.append(start_job("--plain-ref-tensors", d))
        t0 = time.time()
        cmb = phase2(dev, results)
        phase2_matter(dev, results)
        torch.cuda.empty_cache()
        phase2_reverse(dev, results, d, jobs[0])
        torch.cuda.empty_cache()
        phase2_reverse_cmb(dev, results, cmb, d, jobs[1])
        del cmb
        torch.cuda.empty_cache()
        phase2_reverse_tensors(dev, results, ten, d, jobs[2])
        log(f"phase 2 done in {time.time() - t0:.1f} s")
    finally:
        for proc in jobs:
            stop_job(proc)
    with open(os.path.join(d, "phase2.json"), "w") as f:
        json.dump(results, f)
    return 0


def phase2_alive(proc):
    """Raise (with the process's log) if the `--phase2` process failed."""
    rc = proc.poll()
    if rc not in (None, 0):
        with open(proc.log_f.name) as f:
            for line in f.read().strip().splitlines()[-40:]:
                log(f"  | {line}")
    require(rc in (None, 0), "phase 2 (a process on the card) runs without failing")


def run_phases(dev, tmp, results, launches, segment, jobs):
    """Phases 2-17 in `tmp`; the host-CPU jobs, phase 2's process and the
    HMC CLIs go to `jobs` (main stops any still running)."""
    t0 = time.time()
    p2dir, refdir, graddir = (os.path.join(tmp, n) for n in ("phase2", "reverse",
                                                             "grad"))
    for n in (p2dir, refdir, graddir):
        os.makedirs(n)
    p2 = start_job("--phase2", p2dir)
    jobs.append(p2)
    sets = lss_bbn_sets(dev, tmp)
    with open(os.path.join(graddir, "sets.json"), "w") as f:
        json.dump(lss_paths(sets), f)
    cpu_grad = start_job("--cpu-grad", graddir)
    jobs.append(cpu_grad)
    flagdir = os.path.join(tmp, "grad_flagship")
    os.makedirs(flagdir)
    ds = smooth_plik_fiducial(flagdir)
    with open(os.path.join(flagdir, "flag.json"), "w") as f:
        json.dump(dict(ds=ds), f)
    cpu_grad_cmb = start_job("--cpu-grad-cmb", flagdir)
    jobs.append(cpu_grad_cmb)
    cpu_grad_lcdm_r = start_job("--cpu-grad-lcdm-r", flagdir)
    jobs.append(cpu_grad_lcdm_r)
    ext_cpu_jobs = {}
    for label, dd in ext_small_sets(dev, os.path.join(tmp, "grad_ext"), ds).items():
        ext_cpu_jobs[label] = (start_job("--cpu-grad-ext", dd), dd)
        jobs.append(ext_cpu_jobs[label][0])
    vi_ext = ext_reverse_inputs(dev, refdir)
    ext_ref_jobs = [start_job(m, refdir) for m in PLAIN_REF_EXT_PARTS]
    jobs.extend(ext_ref_jobs)
    carddir = os.path.join(tmp, "plain_card")
    os.makedirs(carddir)
    torch.cuda.synchronize()
    card_jobs = [start_job(m, carddir) for m in PLAIN_CARD_PARTS]
    jobs.extend(card_jobs)
    log(f"phase 2's process on the card and the host-CPU jobs started in "
        f"{time.time() - t0:.1f} s (phase 2's log follows phase 16)")
    for phase, label, cfg in (
            (3, "flagship", {}),
            (4, "lcdm_r", dict(compute_tensors=True,
                               los_method="recurrence"))):
        t0 = time.time()
        launches[label], segment[label], fid = drive_path(dev, tmp, label,
                                                          cfg)
        if label == "flagship":
            flagship_fid = fid
        log(f"phase {phase} done in {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["runner"], segment["runner"] = drive_runner(dev, tmp,
                                                         flagship_fid)
    log(f"phase 5 done in {time.time() - t0:.1f} s")
    flag_hmc = start_flagship_hmc(tmp, flagship_fid)
    jobs.append(flag_hmc)
    t0 = time.time()
    launches["background"], bg_sets = drive_background(dev, tmp)
    segment["background"] = dict(launches["background"])
    log(f"phase 6 done in {time.time() - t0:.1f} s")
    phase2_alive(p2)
    t0 = time.time()
    launches["flagship_mp"], segment["flagship_mp"] = drive_matter_power(
        dev, tmp, flagship_fid)
    log(f"phase 7 done in {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["astro"], segment["astro"] = drive_astro(dev, tmp)
    log(f"phase 8 done in {time.time() - t0:.1f} s")
    t0 = time.time()
    sigma8_mnu_anchors(dev)
    ext_sets = {}
    launches["mnu"], segment["mnu"], ext_sets["mnu"] = drive_extended(
        dev, tmp, "mnu")
    log(f"phase 9 done in {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["w0wa"], segment["w0wa"], ext_sets["w0wa"] = drive_extended(
        dev, tmp, "w0wa")
    iso_response(dev)
    log(f"phase 10 done in {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["spt"], segment["spt"] = drive_spt(dev, tmp, flagship_fid)
    log(f"phase 11 done in {time.time() - t0:.1f} s")
    phase2_alive(p2)
    t0 = time.time()
    launches["lss_bbn"], segment["lss_bbn"] = drive_lss_bbn(dev, tmp, sets)
    action4_table(flagship_fid["post"])
    log(f"phase 12 done in {time.time() - t0:.1f} s")
    # from here on the CLI processes, phase 2's and this one share the
    # card's memory: each phase hands back what it cached
    torch.cuda.empty_cache()
    cli = flagship_cli_runs(dev, os.path.join(tmp, "driver"), flagship_fid)
    jobs.extend(cli["procs"])
    t0 = time.time()
    plain_card = {}
    for m, job in zip(PLAIN_CARD_PARTS, card_jobs):
        plain_card.update(finish_job(
            job, carddir, m.strip("-").replace("-", "_") + ".pt",
            f"the plain K1 extended instantiations {PLAIN_CARD_PARTS[m]} (on the card)"))
    phase2_variants(dev, results, plain_card)
    phase2_reverse_ext(dev, results, refdir, ext_ref_jobs, vi_ext)
    del vi_ext
    log(f"phase 2 (K1's extended instantiations and their reverse kernels) "
        f"done in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    hmc_proc = start_hmc(tmp, sets)
    jobs.append(hmc_proc)
    ext_hmc = start_ext_hmc(tmp, ext_sets["mnu"])
    jobs.append(ext_hmc)
    t0 = time.time()
    launches["driver"], segment["driver"] = drive_driver(
        dev, tmp, flagship_fid, bg_sets, cli)
    log(f"phase 13 done in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    phase2_alive(p2)
    ext_min = start_ext_min(tmp, ext_sets["w0wa"])
    jobs.append(ext_min[0])
    lcdm_r_hmc = start_lcdm_r_hmc(tmp, flagship_fid)
    jobs.append(lcdm_r_hmc[0])
    t0 = time.time()
    launches["gradient"], segment["gradient"] = drive_gradient(
        dev, tmp, sets, cpu_grad, graddir, hmc_proc)
    log(f"phase 14 done in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    launches["flagship_grad"], segment["flagship_grad"] = drive_flagship_gradient(
        dev, tmp, flagship_fid, cpu_grad_cmb, flagdir, flag_hmc)
    log(f"phase 15 done in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    by_path, one = drive_ext_gradient(dev, tmp, ext_sets, ext_cpu_jobs, ext_hmc,
                                      ext_min)
    launches.update(by_path)
    segment.update(one)
    log(f"phase 16 done in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    launches["lcdm_r_grad"], segment["lcdm_r_grad"] = drive_lcdm_r_gradient(
        dev, tmp, flagship_fid, cpu_grad_lcdm_r, flagdir, lcdm_r_hmc)
    log(f"phase 17 done in {time.time() - t0:.1f} s")
    t0 = time.time()
    try:
        rc = p2.wait(timeout=JOB_TIMEOUT)
    finally:
        stop_job(p2)
        p2.log_f.close()
    with open(p2.log_f.name) as f:
        text = f.read()
    log("phase 2 (its process on the card):")
    for line in text.strip().splitlines():
        log(f"  | {line}")
    require(rc == 0, "phase 2 (a process on the card) exits 0")
    with open(os.path.join(p2dir, "phase2.json")) as f:
        results.update(json.load(f))
    log(f"phase 2's process: waited {time.time() - t0:.1f} s for it")


def main() -> int:
    jobs = {"--plain-ref": plain_references, "--cpu-grad": cpu_gradient,
            "--plain-ref-cmb": plain_references_cmb,
            "--cpu-grad-cmb": cpu_gradient_cmb, "--plain-card": variant_plain_refs,
            "--plain-card-de": lambda d: variant_plain_refs(d, "--plain-card-de"),
            **{m: (lambda m: lambda d: plain_references_ext(d, m))(m)
               for m in PLAIN_REF_EXT_PARTS},
            "--cpu-grad-ext": cpu_gradient_ext, "--ext-min": ext_min_job,
            "--phase2": phase2_job, "--plain-ref-tensors": plain_references_tensors,
            "--cpu-grad-lcdm-r": cpu_gradient_lcdm_r, "--lcdm-r-hmc": lcdm_r_hmc_job}
    if len(sys.argv) == 3 and sys.argv[1] in jobs:
        # a process of its own on the host CPU or the card (start_job)
        sys.path.insert(0, HERE)
        return jobs[sys.argv[1]](sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from cosmomc_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.build, kernels.SOURCES))
    for name in kernels.SOURCES:
        kernels.load(name)
    log(f"phase 1: built {len(kernels.SOURCES)} kernels in "
        f"{time.time() - t0:.1f} s " + json.dumps(
            {k: round(v, 1) for k, v in kernels.build_seconds.items()}))
    for name, text in kernels.build_log.items():
        kind = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kind = kernel_of(line)
            elif "registers" in line or "spill stores" in line:
                log(f"  ptxas {name} [{kind}]: {line.split('info    :')[-1].strip()}")

    results = {}
    launches, segment = {}, {}
    jobs = []
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE)) as tmp:
        try:
            run_phases(dev, tmp, results, launches, segment, jobs)
        finally:
            for proc in jobs:
                stop_job(proc)

    rows = []
    for n, (src, rep) in KERNELS.items():
        by_path = {p: launches[p][n] for p in PATH_KERNELS}
        r = results[n]
        log(f"  {n:10s} {r['ms']:9.3f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it)")
        # library_ms: no single PyTorch call computes any of these functions
        rows.append(dict(name=n, route="cuda", source=src, replaces=rep,
                         launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         launches_per_segment={p: segment[p][n]
                                               for p in PATH_KERNELS},
                         library_ms=None, **r))
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
