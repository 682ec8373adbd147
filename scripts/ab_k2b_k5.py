#!/usr/bin/env python3
"""Time the redesigned K2b (recurrence LOS) and K5 (tensor RK4) CUDA kernels
of cosmomc_tpu_torch against their first versions, on one card, in turns
(old, new, new, old), at the LCDM+r path's shapes.

    git archive 9ecfa03 cosmomc_tpu_torch/csrc | tar -x -C _scratch/parent
    python3 scripts/ab_k2b_k5.py --parent _scratch/parent

The first versions are the ones where the 256 threads of a block split the
strided tau nodes and walk every l (K2b) and one thread owns one (chain, k)
lane (K5). Their csrc/los_recurrence.cu and csrc/tensors.cu are compiled
with the same nvcc flags and called through their own C entry points, whose
signatures this script knows (FIRST_ABI); a tree whose sources declare any
other signature, or whose sources are the current ones, is refused
(ab_k3_k2a.build_parent). Both see the same float32 inputs, built as the
main path builds them at the best fit: K2b on the 8192-step Boltzmann
sources of 8 chains, 109 sampled l (walked 2..2658) x 4521 fine k x 2048
tau nodes (stride 4); K5 on the stage tables of 8 chains x 96 k on the
8192-step grid (the main path) and the 2048-step grid (where chip_smoke
holds K5 to its plain version), and one (chain, k) lane of the latter. Each
time is the mean over --reps calls by CUDA events, wrapper included; the
results of old and new are compared. Then torch.profiler gives the device
time of each new kernel, and nvidia-smi the SM clock while the new kernel
runs alone (read every 0.1 s over CLOCK_SECONDS of calls). Prints one JSON
object as the last line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from ab_k3_k2a import build_parent, kernel_name, rel_err  # noqa: E402
from ab_k4_k1 import timed  # noqa: E402
from cosmomc_tpu_torch import kernels  # noqa: E402
from cosmomc_tpu_torch.models import cls as mcls  # noqa: E402
from cosmomc_tpu_torch.models import perturbations as mpert  # noqa: E402
from cosmomc_tpu_torch.models import recfast as mrec  # noqa: E402
from cosmomc_tpu_torch.models import tensors as mten  # noqa: E402
from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn  # noqa: E402
from cosmomc_tpu_torch.models.cmb import source_k_grid  # noqa: E402
from cosmomc_tpu_torch.models.reionization import zre_from_tau  # noqa: E402
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization  # noqa: E402

C = 8
LMAX = 2658
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020, tau=0.05430138)
F32, F64 = torch.float32, torch.float64
CLOCK_SECONDS = 1.5   # of new calls a kernel while the SM clock is read
#: source -> (entry point, its parameters) of the first versions
FIRST_ABI = {
    "los_recurrence.cu": ("NAME", "const void* src, const void* idx, const void* w, "
                          "const void* kf, const void* chi, const void* wt, "
                          "const void* wl, const void* ls, const void* cut, void* out, "
                          "int C, int nk, int nt, int nl, int nkf, void* stream"),
    "tensors.cu": ("tensors_f32", "const void* qtab, const void* kvec, void* out, "
                   "int C, int S, int nk, int substeps, int feedback, void* stream"),
}


class SmClock:
    """The SM clock (MHz), read by nvidia-smi every 0.1 s in a thread while
    the block runs."""
    def __enter__(self):
        self.mhz, self.done = [], threading.Event()

        def read():
            while not self.done.is_set():
                r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader,nounits"],
                                   capture_output=True, text=True)
                if r.returncode == 0:
                    self.mhz.append(float(r.stdout.split()[0]))
                self.done.wait(0.1)
        self.thread = threading.Thread(target=read)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.done.set()
        self.thread.join()


def inputs(dev):
    """The float32 inputs of K2b and K5 on the main path at the best fit
    (8 chains, scattered by 0.2%)."""
    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (C, 1))
    for n, v in BESTFIT.items():
        full[:, space.index(n)] = v * (1 + 0.002 * rng.standard_normal(C))
    full = torch.as_tensor(full, dtype=F64, device=dev)
    bg = par.to_background(full)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, F64))
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    kgrid = source_k_grid(kmax=0.5)
    tf, tau0 = mpert.build_thermo_funcs(bg, yhe, th, zre)
    po = mpert.evolve_perturbations(bg, tf, tau0, torch.as_tensor(kgrid, dtype=F64,
                                                                    device=dev))
    ipk = torch.argmax(tf.vis, -1, keepdim=True)
    chi_star = (tau0 - tf.tau.gather(-1, ipk)[:, 0]).float()
    fields = ("tau", "k", "s0", "s1", "s2", "slens", "tau0")
    po = po._replace(**{f: getattr(po, f).float() for f in fields})
    src, chi, wt, wl = mcls._los_inputs(po, chi_star, 4)
    ls, kf, _, idx, w, cut = mcls._rec_plan(LMAX, 14200.0, 0.5, 4.0,
                                            tuple(np.asarray(kgrid, np.float64).tolist()))
    f = lambda a: torch.as_tensor(a, dtype=F32, device=dev)
    rec = (src, torch.as_tensor(idx, dtype=torch.int32, device=dev), f(w), f(kf), chi,
           wt, wl, torch.as_tensor(ls, dtype=torch.int32, device=dev), f(cut))
    kt = torch.as_tensor(mten.tensor_k_grid(), dtype=F32, device=dev)
    qt = {mpert.N_STEP: mten._stage_table(bg, tf, 1).float().contiguous()}
    tf2, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=2048)
    qt[2048] = mten._stage_table(bg, tf2, 1).float().contiguous()
    return rec, qt, kt


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked tree holding the first versions' "
                         "cosmomc_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_k2b_k5: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    old_rec = build_parent(args.parent, "los_rec", "los_recurrence.cu", FIRST_ABI,
                           "ab_k2b_k5").los_rec_f32
    old_ten = build_parent(args.parent, "tensors", "tensors.cu", FIRST_ABI,
                           "ab_k2b_k5").tensors_f32
    kernels.load("los_rec")
    kernels.load("tensors")
    for name in ("los_rec", "tensors"):
        for line in kernels.build_log.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name} (new): " + line.split("info    :")[-1].strip())

    def rec_old(src, idx, w, kf, chi, wt, wl, ls, cut):
        Cn, _, nk, nt = src.shape
        out = torch.empty(3, Cn, ls.shape[0], kf.shape[0], dtype=src.dtype, device=dev)
        kernels.call(old_rec, src, idx, w, kf, chi, wt, wl, ls, cut, out, Cn, nk, nt,
                     ls.shape[0], kf.shape[0])
        return out

    def rec_new(*a):
        return mcls._los_rec_cuda(*a, 0)

    def ten_old(q, k):
        out = torch.empty(len(mten.T_PLANES), q.shape[0], q.shape[1], k.shape[0],
                          dtype=q.dtype, device=dev)
        kernels.call(old_ten, q, k, out, q.shape[0], q.shape[1], k.shape[0], 1, True)
        return out

    def ten_new(q, k):
        return mten._evolve_t_cuda(q, k, 1, True)

    rec, qt, kt = inputs(dev)
    one = lambda t: t[:1].contiguous()
    cases = (
        ("los_rec", rec_old, rec_new, rec),
        ("tensors_8192", ten_old, ten_new, (qt[mpert.N_STEP], kt)),
        ("tensors_2048", ten_old, ten_new, (qt[2048], kt)),
        ("tensors_2048_one_lane", ten_old, ten_new,
         (one(qt[2048]), kt[-1:].contiguous())))
    # what the new kernels' data-dependent savings see in these inputs: the
    # (k, tau, l) points above the Airy cut and those K2b walks; the steps
    # whose first table row repeats the last row before (there K5 does four
    # RHS evaluations, not five), the stages past the freeze and the held steps
    q = qt[mpert.N_STEP]
    tau = q[..., mten.QT_TAU]
    lat = mcls.rec_lattice(rec[4], rec[3], rec[8])
    res = {"device": smi, "los_rec_lattice": lat,
           "los_rec_l0": mcls.rec_l0(LMAX, F32),
           "tensors_steps_with_repeated_row": float(
               (q[:, 1:, 0] == q[:, :-1, -1]).all(-1).float().mean()),
           "tensors_frozen_stages": float(
               (kt * tau[..., None] >= mten.RSA_KTAU_T).float().mean()),
           "tensors_held_steps": float(
               (kt * tau[:, :, -1, None] < mten.RELEASE_KTAU_T).float().mean())}
    print(json.dumps(res), flush=True)
    for name, old, new, inp in cases:
        err = rel_err(new(*inp), old(*inp))
        ms = {"old": [], "new": []}
        for label, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
            ms[label].append(timed(lambda: fn(*inp), args.reps))
        res[name] = dict(old_ms=ms["old"], new_ms=ms["new"],
                         speedup=sum(ms["old"]) / sum(ms["new"]),
                         new_vs_old_rel_err=err, reps=args.reps)
        print(f"{name}: old {ms['old']} ms, new {ms['new']} ms, "
              f"speed-up {res[name]['speedup']:.2f}x, new vs old rel err {err:.2e}",
              flush=True)
    for name, _, new, inp in cases:
        new(*inp)
        torch.cuda.synchronize()
        calls = max(1, int(1e3 * CLOCK_SECONDS / min(res[name]["new_ms"])))
        with SmClock() as clk:
            t = timed(lambda: new(*inp), calls)
        res[name]["sm_clock_mhz"] = dict(
            median=statistics.median(clk.mhz), min=min(clk.mhz), max=max(clk.mhz),
            reads=len(clk.mhz), calls=calls, ms_per_call=t)
        print(f"{name} SM clock while the new kernel runs: "
              + json.dumps(res[name]["sm_clock_mhz"]), flush=True)
    from torch.profiler import ProfilerActivity, profile
    for name, _, new, inp in cases:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                new(*inp)
            torch.cuda.synchronize()
        per = {kernel_name(e.key): e.device_time_total / 5e3
               for e in prof.key_averages() if e.device_time_total > 0}
        res[name]["device_ms_by_kernel"] = per
        print(f"{name} device ms by kernel: " + json.dumps(per), flush=True)
    print(smi)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
