#!/usr/bin/env python3
"""K3's reverse kernel (lensing_bwd) against autograd of its plain version
with and without FMA contraction, on one card.

    python3 scripts/k3_bwd_rounding.py

csrc/lensing.cu is built twice into the build directory, with the flags
of the committed kernels without `kernels.EXTRA_FLAGS["lensing"]` (nvcc
contracts products and sums into FMAs) and with them (-fmad=false, as the
port builds it), and each build's `lensing_bwd` runs on 2 chains of smooth
spectra (l 2..2658 -> 2508, 5315 theta, a seeded cotangent on the pass-3
sums), float64. It prints, for each build, each cotangent row's (CTT, CTE,
CEE, Cphil3) largest difference from autograd of `_passes_plain` on the
card over that row's largest magnitude, and the forward's against the
plain version's; the last line is one JSON object of them. chip_smoke.py
holds the committed build to 1e-9 (phase 2); the C^EE row is the one the
contraction moves.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from cosmomc_tpu_torch import kernels  # noqa: E402
from cosmomc_tpu_torch.models import lensing as tlens  # noqa: E402

F64 = torch.float64
L, NL_OUT = 2657, 2507


def build(extra):
    tag = "nofma" if extra else "fma"
    out = os.path.join(kernels.BUILD_DIR, f"liblensing_{tag}.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *extra, "-I",
                          kernels.CSRC, "-o", out,
                          os.path.join(kernels.CSRC, "lensing.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-3000:])
    return ctypes.CDLL(out)


def spectra(dev):
    l = np.arange(2, L + 2, dtype=np.float64)
    rows = []
    for a in (1.0, 1.1):
        damp = np.exp(-(l / 1400.0) ** 2)
        tt = a * 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0) ** 2)
        ee = a * 40.0 * damp * (l / 1000.0) * (1 + np.sin(np.pi * l / 300.0) ** 2)
        te = 0.4 * np.sqrt(tt * ee) * np.cos(np.pi * l / 150.0)
        pp = a * 1.8e-7 * (l / 40.0) / (1.0 + (l / 40.0) ** 2) ** 1.2
        rows.append(tlens.lens_inputs(torch.as_tensor(l), *(torch.as_tensor(x)[None]
                                                            for x in (tt, te, ee, pp)))[0])
    return torch.stack(rows).to(dev)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def main():
    if not torch.cuda.is_available():
        print("k3_bwd_rounding: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cl = spectra(dev)
    n_theta = 2 * (L + 1)
    gs = torch.randn(2, NL_OUT, 4, generator=torch.Generator().manual_seed(0),
                     dtype=F64).to(dev)
    x = cl.clone().requires_grad_(True)
    sums_ref = tlens._passes_grid_plain(x, n_theta, True, NL_OUT)
    (ref,) = torch.autograd.grad((sums_ref * gs).sum(), [x])
    out = {}
    for name, extra in (("with FMA contraction", []),
                        ("without (-fmad=false)", kernels.EXTRA_FLAGS["lensing"])):
        kernels._libs["lensing"] = build(extra)
        sums, sgcg = tlens._passes_launch(cl, n_theta, True, NL_OUT)
        g = tlens._passes_bwd_cuda(cl, sgcg, gs, n_theta, True, NL_OUT)
        torch.cuda.synchronize()
        out[name] = dict(forward=rel(sums, sums_ref.detach()),
                         **{f"grad_{q}": rel(g[:, i], ref[:, i]) for i, q in
                            enumerate(("CTT", "CTE", "CEE", "Cphil3"))})
        print(name, out[name], flush=True)
    kernels._libs.pop("lensing")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
