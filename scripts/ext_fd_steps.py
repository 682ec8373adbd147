#!/usr/bin/env python3
"""Central differences of -logL against the exact gradient on phase 16's
configurations (base_mnu; base_w_wa with alpha1 free), at several steps,
on one card:

    python3 scripts/ext_fd_steps.py

It builds the kernels, makes phases 9's and 10's sets
(chip_smoke.drive_extended), then for each configuration without halofit
lensing (chip_smoke.ext_grad_posterior, float64, full width) takes the
gradient at phase 16's two points and central differences at each of
STEPS proposal widths, and prints the largest |fd - grad| / max |grad| of
each point and the three parameters that contribute it. -logL is
piecewise smooth (grids that move with the parameters, the TCA/RSA and
nu_rel_rsa switches), so the differences carry its float64 rounding at
small steps and its kinks at large ones. About five minutes on an H100.
"""

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
STEPS = (1e-7, 3e-7, 1e-6, 3e-6, 1e-5)


def main() -> int:
    if not torch.cuda.is_available():
        print("ext_fd_steps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cosmomc_tpu_torch import kernels
    dev = torch.device("cuda")
    cs.log(cs.smi_line())
    with ThreadPoolExecutor(max_workers=len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.build, kernels.SOURCES))
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        for label in cs.EXT_GRAD:
            t0 = time.time()
            sets = cs.drive_extended(dev, tmp, label)[2]
            lin = cs.ext_grad_posterior(dev, label, sets["ds"], sets["dr12"],
                                        nonlinear=False)
            names = [p.name for p in lin.space.varying]
            pts = cs.ext_grad_points(lin, label)
            n = pts.shape[1]
            _, g = cs.grad_at(lin, pts)
            w = np.array([p.propose_width for p in lin.space.varying])
            out[label] = {}
            for f in STEPS:
                h = f * w
                v = cs.mll_at(lin, np.concatenate([x + s * np.diag(h) for x in pts
                                                   for s in (1.0, -1.0)]))
                fd = np.stack([(v[2 * i * n:(2 * i + 1) * n]
                                - v[(2 * i + 1) * n:(2 * i + 2) * n]) / (2.0 * h)
                               for i in range(len(pts))])
                e = np.abs(fd - g) / np.abs(g).max(1, keepdims=True)
                out[label][f] = e.max(1).tolist()
                worst = [[(names[i], float(e[j, i])) for i in np.argsort(-e[j])[:3]]
                         for j in range(len(pts))]
                cs.log(f"{label} step {f:g} widths: max |fd - grad| / max |grad| "
                       f"per point {e.max(1)}; largest {worst}")
            cs.log(f"{label}: gradient {g.tolist()} ({time.time() - t0:.1f} s)")
    print(json.dumps(out))
    cs.log(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
