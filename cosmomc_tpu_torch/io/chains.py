"""GetDist-compatible chain text I/O (port of cosmomc_tpu/io/chains.py,
host numpy: the files are the same bytes for the same arrays).

Format (reference: source/IO.f90 `IO_OutputChainRow`): one row per retained
point, ``weight  -logLike  p1 ... pN  derived1 ...``, files named
``<root>_<i>.txt`` (one per chain), plus sidecar ``.paramnames`` and
``.ranges`` files. GetDist (both the reference Fortran tool and the pip
`getdist` package) consumes exactly this layout.

The vectorized sampler emits lockstep (step, chain) arrays; this module
compresses each chain's step stream into weighted rows (a point's weight =
number of consecutive steps it survived) and appends to per-chain files —
the same on-disk result as the reference's per-rank streaming writes.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class ChainWriter:
    """Accumulates lockstep segment output and writes per-chain text files."""

    def __init__(self, root: str, nchains: int, chain_offset: int = 0):
        self.root = root
        self.nchains = nchains
        self.chain_offset = chain_offset
        os.makedirs(os.path.dirname(root) or ".", exist_ok=True)
        # pending (still-alive) point per chain: weight, mloglike, row values
        self._pending_w = np.zeros(nchains, np.int64)
        self._pending_row: Optional[np.ndarray] = None  # (nchains, ncol)
        self._files = [open(self._fname(i), "a", buffering=1 << 16)
                       for i in range(nchains)]

    def _fname(self, i: int) -> str:
        return f"{self.root}_{i + 1 + self.chain_offset}.txt"

    def add_segment(self, accept: np.ndarray, P: np.ndarray, mloglike: np.ndarray,
                    derived: Optional[np.ndarray] = None) -> None:
        """accept: (S, nchains); P: (S, nchains, n); mloglike: (S, nchains).

        Vectorized run-length encoding per chain: a retained point's weight
        is the number of steps until the next accepted proposal. Formatting
        goes through np.savetxt (C fast path) — the naive per-row Python
        loop was the wall-clock bottleneck of whole runs.
        """
        S, nchains = accept.shape
        cols = [mloglike[..., None], P]
        if derived is not None and derived.shape[-1] > 0:
            cols.append(derived)
        rows = np.concatenate(cols, axis=-1)  # (S, nchains, 1+n+nd)
        first = self._pending_row is None
        if first:
            self._pending_row = np.empty((nchains, rows.shape[-1]))
        for c in range(nchains):
            acc_idx = np.nonzero(accept[:, c])[0]
            if first:
                # chain starts at step 0's point
                if acc_idx.size == 0 or acc_idx[0] != 0:
                    acc_idx = np.concatenate([[0], acc_idx])
            if acc_idx.size == 0:
                self._pending_w[c] += S
                continue
            # flush the carried point (weight += steps before first accept)
            if not first and self._pending_w[c] + acc_idx[0] > 0:
                self._write_rows(c, self._pending_row[c][None, :],
                                 np.array([self._pending_w[c] + acc_idx[0]]))
            # interior accepted points: weight = gap to the next accept
            if acc_idx.size > 1:
                w = np.diff(acc_idx)
                self._write_rows(c, rows[acc_idx[:-1], c], w)
            # last accepted point stays pending
            self._pending_row[c] = rows[acc_idx[-1], c]
            self._pending_w[c] = S - acc_idx[-1]

    def _write_rows(self, c: int, block: np.ndarray, weights: np.ndarray) -> None:
        out = np.concatenate([weights[:, None].astype(float), block], axis=1)
        np.savetxt(self._files[c], out, fmt="%.7E")

    def _flush_point(self, c: int) -> None:
        if self._pending_row is not None and self._pending_w[c] > 0:
            self._write_rows(c, self._pending_row[c][None, :],
                             np.array([self._pending_w[c]]))
            self._pending_w[c] = 0

    def close(self, flush_pending: bool = True) -> None:
        for c in range(self.nchains):
            if flush_pending and self._pending_row is not None:
                self._flush_point(c)
            self._files[c].close()


def load_chain(path: str) -> dict:
    """Load one chain text file -> dict(weights, mloglike, samples)."""
    dat = np.loadtxt(path)
    if dat.ndim == 1:
        dat = dat[None, :]
    return dict(weights=dat[:, 0], mloglike=dat[:, 1], samples=dat[:, 2:])


def load_chains(root: str, nchains: Optional[int] = None) -> dict:
    """Load root_1.txt.. concatenated, GetDist-style."""
    out = {"weights": [], "mloglike": [], "samples": []}
    i = 1
    while True:
        p = f"{root}_{i}.txt"
        if not os.path.isfile(p) or (nchains is not None and i > nchains):
            break
        d = load_chain(p)
        for k in out:
            out[k].append(d[k])
        i += 1
    if not out["weights"]:
        raise FileNotFoundError(f"no chains found for root {root}")
    return {k: np.concatenate(v) for k, v in out.items()}
