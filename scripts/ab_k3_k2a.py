#!/usr/bin/env python3
"""Time the redesigned K3 (lensing) and K2a (table LOS) CUDA kernels of
cosmomc_tpu_torch against their first versions, on one card, in turns
(old, new, new, old), at the flagship path's shapes.

    git archive <commit> | tar -x -C _scratch/parent
    python3 scripts/ab_k3_k2a.py --parent _scratch/parent

The first versions are the ones with one thread per (chain, theta) and
per-warp partials (K3) and one thread per (chain, k, 4 l) reading separate
j_l and j_l' tables (K2a). Their csrc/lensing.cu and csrc/cls.cu are
compiled with the same nvcc flags and called through their own C entry
points, whose signatures this script knows (FIRST_ABI); a tree whose
sources declare any other signature is refused, since a mismatch would
pass the wrong arguments to a C function. Both see the same float32 inputs:
8 chains, lensing l = 2..2658 -> 2508 on 5315 theta (smooth spectra: the
kernel's work does not depend on their values), LOS 109 sampled l x 4521
fine k x 2048 tau nodes from the 8192-step Boltzmann sources at the best
fit. Each time is the mean over --reps calls by CUDA events, wrapper
included; the results of old and new are compared. Then torch.profiler
gives the device time of each CUDA kernel the new wrappers launch (K3 runs
six). Prints one JSON object as the last line.
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from cosmomc_tpu_torch import kernels  # noqa: E402
from cosmomc_tpu_torch.models import cls as mcls  # noqa: E402
from cosmomc_tpu_torch.models import lensing as mlens  # noqa: E402
from cosmomc_tpu_torch.models import perturbations as mpert  # noqa: E402
from cosmomc_tpu_torch.models import recfast as mrec  # noqa: E402
from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn  # noqa: E402
from cosmomc_tpu_torch.models.cmb import source_k_grid  # noqa: E402
from cosmomc_tpu_torch.models.reionization import zre_from_tau  # noqa: E402
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization  # noqa: E402

C = 8
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020, tau=0.05430138)
#: source -> (entry point, its parameters) of the first versions
FIRST_ABI = {
    "lensing.cu": ("lensing_f32", "const void* cl, const void* th, void* partial, "
                   "void* sums, int C, int L, int nth, int nl_out, int n_warps, "
                   "void* stream"),
    "cls.cu": ("NAME", "const void* src, const void* idx, const void* w, "
               "const void* kf, const void* chi, const void* wt, const void* wl, "
               "const void* jl, const void* jlp, const void* ls, void* out, "
               "int C, int nk, int nt, int nl, int nx, int nkf, double inv_dx, "
               "void* stream"),
}


def build_parent(parent: str, name: str, src: str, abi=None,
                 who: str = "ab_k3_k2a") -> ctypes.CDLL:
    """Compile the first version of csrc/<src> from the tree `parent`, after
    checking that it is not this tree's source and declares the entry point
    `abi[src]` (by default FIRST_ABI's)."""
    path = os.path.join(parent, "cosmomc_tpu_torch", "csrc", src)
    with open(path, "rb") as f:
        text = f.read()
    with open(os.path.join(kernels.CSRC, src), "rb") as f:
        if f.read() == text:
            sys.exit(f"{who}: {path} is this tree's {src}, not a first version")
    fn, params = (abi or FIRST_ABI)[src]
    m = re.search(rf'extern "C" int {fn}\(([^)]*)\)',
                  text.decode().replace("\\\n", " "))
    if not m or " ".join(m.group(1).split()) != params:
        sys.exit(f"{who}: {path} does not declare the first version's "
                 f"{fn}({params})")
    h = hashlib.sha1(text).hexdigest()[:12]
    out = os.path.join(kernels.BUILD_DIR, f"libparent_{name}_{h}.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if not os.path.exists(out):
        res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                              os.path.dirname(path), "-o", out, path], check=True,
                             capture_output=True, text=True)
        # the first version's registers and spills, as ptxas reports them
        for line in res.stderr.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {src} (first version): "
                      + line.split("info    :")[-1].strip(), flush=True)
    return ctypes.CDLL(out)


def timed(fn, reps):
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def kernel_name(key):
    """'void (anonymous namespace)::pass2_kernel<float>(...)' -> 'pass2_kernel'."""
    m = re.search(r"(\w+)(?:<[^>]*>)?\(", key)
    return m.group(1) if m else key


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def lensing_inputs(dev):
    l = torch.arange(2, 2659, dtype=torch.float64, device=dev)
    damp = torch.exp(-(l / 1400.0) ** 2)
    amp = torch.linspace(1.0, 1.1, C, dtype=torch.float64, device=dev)[:, None]
    tt = amp * 5800.0 * damp * (0.35 + torch.cos(np.pi * l / 300.0) ** 2)
    ee = amp * 40.0 * damp * (l / 1000.0) * (1.0 + torch.sin(np.pi * l / 300.0) ** 2)
    te = 0.4 * torch.sqrt(tt * ee) * torch.cos(np.pi * l / 150.0)
    pp = amp * 1.8e-7 * (l / 40.0) / (1.0 + (l / 40.0) ** 2) ** 1.2
    llp1, f = l * (l + 1), (2 * l + 1) / (4 * np.pi)
    conv = 2 * np.pi / llp1
    cl = torch.stack([tt * conv * f, te * conv * f, ee * conv * f,
                      pp * (2 * np.pi / llp1 ** 2) * llp1 * f], 1)
    return cl.float().contiguous(), 2 * 2658, True, 2507


def los_inputs(dev):
    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (C, 1))
    for n, v in BESTFIT.items():
        full[:, space.index(n)] = v * (1 + 0.002 * rng.standard_normal(C))
    full = torch.as_tensor(full, dtype=torch.float64, device=dev)
    bg = par.to_background(full)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, torch.float64))
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    kgrid = source_k_grid(kmax=0.5)
    k = torch.as_tensor(kgrid, dtype=torch.float64, device=dev)
    tf, tau0 = mpert.build_thermo_funcs(bg, yhe, th, zre)
    po = mpert.evolve_perturbations(bg, tf, tau0, k)
    ipk = torch.argmax(tf.vis, -1, keepdim=True)
    chi_star = (tau0 - tf.tau.gather(-1, ipk)[:, 0]).float()
    fields = ("tau", "k", "s0", "s1", "s2", "slens", "tau0")
    po = po._replace(**{f: getattr(po, f).float() for f in fields})
    key = (2658, 14200.0, 0.5, 4.0, 256, tuple(np.asarray(kgrid, np.float64).tolist()))
    plan = mcls._plan(*key)
    dp = mcls._device_plan(key, str(dev), torch.float32)
    src, chi, wt, wl = mcls._los_inputs(po, chi_star, 4)
    inv_dx = float(torch.tensor(1.0 / plan.dx, dtype=torch.float32))
    return src, dp, chi, wt, wl, inv_dx


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked tree holding the first versions' "
                         "cosmomc_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_k3_k2a: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    old_lens = build_parent(args.parent, "lensing", "lensing.cu").lensing_f32
    old_los = build_parent(args.parent, "los", "cls.cu").los_f32

    def lens_old(cl, n_theta, apodize, nl_out):
        Cn, _, L = cl.shape
        th = mlens.theta_table(n_theta, apodize, dev)
        nth = th.shape[1]
        n_warps = -(-nth // 128) * 4
        partial = torch.empty(Cn, n_warps, nl_out, 4, dtype=torch.float64, device=dev)
        sums = torch.empty(Cn, nl_out, 4, dtype=cl.dtype, device=dev)
        kernels.call(old_lens, cl, th, partial, sums, Cn, L, nth, nl_out, n_warps)
        return sums

    jl_c = {}

    def los_old(src, dp, chi, wt, wl, inv_dx):
        Cn, _, nk, nt = src.shape
        nl, nx = dp["jl"].shape
        kf = dp["kf"]
        if not jl_c:     # the first kernel reads two separate tables
            jl_c.update(jl=dp["jl"].contiguous(), jlp=dp["jlp"].contiguous())
        out = torch.empty(3, Cn, nl, kf.shape[0], dtype=src.dtype, device=dev)
        kernels.call(old_los, src, dp["idx"], dp["w"], kf, chi, wt, wl, jl_c["jl"],
                     jl_c["jlp"], dp["ls"], out, Cn, nk, nt, nl, nx, kf.shape[0], inv_dx)
        return out

    res = {"device": smi}
    for name, old, new, inp in (("lensing", lens_old, mlens._passes_cuda, lensing_inputs(dev)),
                                ("los", los_old, mcls._los_cuda, los_inputs(dev))):
        ms = {}
        for turn, (label, fn) in enumerate((("old", old), ("new", new), ("new", new),
                                            ("old", old))):
            t, out = timed(lambda: fn(*inp), args.reps)
            ms.setdefault(label, []).append(t)
            if label == "old":
                o_out = out
            else:
                n_out = out
        err = rel_err(n_out, o_out)
        res[name] = dict(old_ms=ms["old"], new_ms=ms["new"],
                         speedup=sum(ms["old"]) / sum(ms["new"]),
                         new_vs_old_rel_err=err, reps=args.reps)
        print(f"{name}: old {ms['old']} ms, new {ms['new']} ms, "
              f"speed-up {res[name]['speedup']:.2f}x, new vs old rel err {err:.2e}",
              flush=True)
    from torch.profiler import ProfilerActivity, profile
    for name, new, inp in (("lensing", mlens._passes_cuda, lensing_inputs(dev)),
                           ("los", mcls._los_cuda, los_inputs(dev))):
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
