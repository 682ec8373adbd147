"""The flagship's action-2 Hessian from differences of exact gradients, at
several steps: how stable are its eigenvalues?

Action 2 on a posterior with a slow stage (driver.HESSIAN_STEP) takes
H_ij = (g_i(p + h_j e_j) - g_i(p - h_j e_j)) / 2 h_j, with g the gradient
through the reverse kernels. The slow path's -logL is piecewise smooth, so
g carries small jumps and a small h turns them into noise in H. This
script builds chip_smoke.py's flagship (phase 3's plik_lite fiducial,
phase 5's DR12-shaped set, the tau prior, float64), runs the minimizer as
chip_smoke.py phase 15 (e) does, twice, and prints for each best fit and
for the centre the eigenvalues of H in proposal-width units (H_ij w_i w_j)
and the largest asymmetry |H - H^T| / max |H| at steps of 1e-3 .. 0.3
widths. Needs one CUDA card:

    python scripts/flagship_hessian_steps.py
"""
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from cosmomc_tpu_torch import kernels  # noqa: E402
from cosmomc_tpu_torch.sampling.minimize import find_best_fit  # noqa: E402

STEPS = (1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1)


def main() -> int:
    if not torch.cuda.is_available():
        print("flagship_hessian_steps: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    t00 = time.time()
    with ThreadPoolExecutor(max_workers=len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.build, kernels.SOURCES))
    for name in kernels.SOURCES:
        kernels.load(name)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        _, _, fid = cs.drive_path(dev, tmp, "flagship", {})
        cs.flagship_dr12(dev, tmp, fid)
        post = cs.flagship_grad_posterior(dev, fid["ds"], fid["dr12"])
    var = post.space.varying
    w = np.array([p.propose_width for p in var])
    lo, hi = np.array([p.min for p in var]), np.array([p.max for p in var])
    lp = post.logpost()
    print("parameters", [p.name for p in var], "widths", w.tolist(), flush=True)

    def hessian(x, f):
        h = f * w
        up, down = np.minimum(x + h, hi) - x, x - np.maximum(x - h, lo)
        n = len(x)
        q = torch.as_tensor(np.concatenate([x + np.diag(up), x - np.diag(down)]),
                            dtype=torch.float64, device=dev).requires_grad_(True)
        (g,) = torch.autograd.grad(lp(q)[0].sum(), q)
        g = g.double().cpu().numpy()
        return (g[:n] - g[n:]) / (up + down)[:, None]

    points = []
    for rep in range(2):
        t0 = time.time()
        b = find_best_fit(lp, post.space, refine_steps=cs.GRAD_MIN_REFINE,
                          refine_chains=8, maxiter=cs.GRAD_MIN_ITER, device=dev,
                          dtype=torch.float64)
        print(f"best fit {rep}: -logL {b.mloglike!r} in {time.time() - t0:.1f} s "
              f"at {b.P.tolist()}", flush=True)
        points.append((f"best fit {rep}", b.P))
    points.append(("centre", cs.bestfit_vector(post)))
    for label, x in points:
        for f in STEPS:
            Hw = hessian(np.asarray(x, float), f) * w[:, None] * w[None, :]
            ev = np.linalg.eigvalsh(0.5 * (Hw + Hw.T))
            asym = np.abs(Hw - Hw.T).max() / np.abs(Hw).max()
            print(f"{label}, step {f:g} widths: eigenvalues "
                  f"{np.array2string(ev, precision=4, max_line_width=200)}; "
                  f"asymmetry {asym:.3e}", flush=True)
    print(f"{cs.smi_line()}; {time.time() - t00:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
