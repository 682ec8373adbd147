#!/usr/bin/env python3
"""Central differences of LCDM+r's -logL against its exact gradient at
several steps, on the host CPU (the plain versions), before phase 17 of
chip_smoke.py takes them on the card:

    python3 scripts/lcdm_r_fd_steps.py [--threads N]

The posterior is phase 17's (chip_smoke.lcdm_r_posterior: plik_lite on a
smooth fiducial + the tau prior, compute_tensors=True, r free, float64,
no halofit) at test_torch_slice.py's small config (chip_smoke.FLAG_SMALL),
at phase 17's two points (chip_smoke.flagship_grad_points: the best fit
with r = 0.1, and 0.3 proposal widths off it). It takes the gradient by
autograd, then central differences at each of STEPS proposal widths (one
batch of 4 n points a step), and prints the largest |fd - grad| / max
|grad| of each point and the parameter that contributes it, and tau0 at
each point. -logL is piecewise smooth, and with tensors one more input
jitters: the tensor line of sight's last node, where chi = tau0 - tau is a
few ulps, reads tau0's last bits. About ten minutes on 4 threads.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
STEPS = (1e-7, 3e-7, 1e-6, 3e-6, 1e-5)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    import chip_smoke as cs
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory() as d:
        post = cs.lcdm_r_posterior(cpu, cs.smooth_plik_fiducial(d), nonlinear=False,
                                   cfg=cs.FLAG_SMALL)
        names = [p.name for p in post.space.varying]
        pts = cs.flagship_grad_points(post)
        n = pts.shape[1]
        t0 = time.time()
        _, g = cs.grad_at(post, pts)
        print(f"gradient at {len(pts)} points in {time.time() - t0:.1f} s; tau0 "
              f"{cs.lcdm_r_tau0(post, pts).tolist()}", flush=True)
        w = np.array([p.propose_width for p in post.space.varying])
        for f in STEPS:
            h = f * w
            t0 = time.time()
            out = cs.mll_at(post, np.concatenate([x + s * np.diag(h) for x in pts
                                                  for s in (1.0, -1.0)]))
            fd = np.stack([(out[2 * i * n:(2 * i + 1) * n]
                            - out[(2 * i + 1) * n:(2 * i + 2) * n]) / (2.0 * h)
                           for i in range(len(pts))])
            for j in range(len(pts)):
                e = np.abs(fd[j] - g[j])
                i = int(np.argmax(e))
                print(f"step {f:g} widths, point {j}: max |fd - grad| / max |grad| "
                      f"{e.max() / np.abs(g[j]).max():.3e} along {names[i]} (grad "
                      f"{g[j, i]:.9e}, fd {fd[j, i]:.9e}); {time.time() - t0:.1f} s",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
