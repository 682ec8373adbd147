"""Blocked random-rotation proposal, vectorized over chains.

Port of cosmomc_tpu/sampling/proposal.py (source/propose.f90:53-298): speed
blocks ordered slow -> fast, the triangular mapping M = diag(sigma) L from
the correlation Cholesky factor, proposals along columns of per-chain
random rotations (classical Gram-Schmidt with re-orthogonalization on
Gaussian matrices), the Exp(1)/rms-normal radius mixture times
`propose_scale`, and a host-built schedule shared by every chain.

Random draws come from a `torch.Generator` passed in by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class ProposalSchedule(NamedTuple):
    """Per-step shared schedule for a segment of S steps (host precomputed).

    `rot_index[t]` selects which pregenerated rotation the scheduled block
    uses at step t: the rotations of a whole segment are drawn at once,
    before its first step."""
    block: np.ndarray     # (S,) int32: which block this step proposes in
    direction: np.ndarray  # (S,) int32: direction index within the block
    rot_index: np.ndarray  # (S,) int32: rotation cycle index within segment
    num_rots: Tuple[int, ...]  # static: rotations needed per block


@dataclass
class BlockedProposal:
    """Host-side proposal builder; produces device mapping matrices + schedules."""
    block_indices: List[np.ndarray]   # varying-param indices per block, slow first
    slow_block_max: int = 1           # blocks [0, slow_block_max) count as slow
    oversample_fast: int = 1
    propose_scale: float = 2.4

    def __post_init__(self):
        self.block_indices = [np.asarray(b, np.int32) for b in self.block_indices
                              if len(b) > 0]
        self.order = np.concatenate(self.block_indices)      # block-order -> varying
        self.n = int(self.order.size)
        self.inv_order = np.empty(self.n, np.int64)
        self.inv_order[self.order] = np.arange(self.n)
        sizes = [len(b) for b in self.block_indices]
        self.block_sizes = sizes
        self.block_starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        self.n_slow = int(sum(sizes[:self.slow_block_max]))
        self._dir_count = np.zeros(len(sizes), np.int64)  # visits per block so far
        self.mapping = None   # (n, n) float32 matrix M (block order)

    # ---------- covariance ----------

    def set_covariance(self, cov: np.ndarray) -> None:
        """Build the triangular mapping M = diag(sigma) L from a covariance
        over the varying parameters (propose.f90 SetCovariance math)."""
        cov = np.asarray(cov, np.float64)
        sig = np.sqrt(np.diag(cov))
        corr = cov / np.outer(sig, sig)
        corr_ord = corr[np.ix_(self.order, self.order)]
        # tolerate semi-definite matrices the way the reference's
        # `zeroed` Cholesky does: add tiny jitter
        jitter = 1e-12
        for _ in range(8):
            try:
                L = np.linalg.cholesky(corr_ord + jitter * np.eye(self.n))
                break
            except np.linalg.LinAlgError:
                jitter *= 100
        else:
            raise np.linalg.LinAlgError("proposal covariance not factorizable")
        M = sig[self.order, None] * L
        self.covariance = cov
        self.mapping = torch.as_tensor(M, dtype=torch.float32)

    # ---------- schedule ----------

    def make_schedule(self, steps: int, rng: np.random.Generator,
                      slow_every: Optional[int] = None,
                      expensive_blocks: Optional[Sequence[int]] = None
                      ) -> ProposalSchedule:
        """Precompute (block, direction, refresh) for `steps` steps, following
        the reference's cycling-permutation visit order with fast oversampling.

        `slow_every` (optional) switches to a *patterned* schedule: exactly
        one expensive-block step every `slow_every` steps (at offsets 0,
        slow_every, ...), all other steps cycling the cheap directions.
        This bounds the number of full-theory recomputes per segment, the
        natural generalization of the reference's oversample_fast
        economics (propose.f90:261-272): cheap
        directions are nearly free against the cached theory, so visiting
        them more often costs nothing. Deterministic block cycling within
        a random-direction proposal remains a valid irreducible MH kernel.
        `expensive_blocks` lists the block indices that count as expensive
        (default: blocks [0, slow_block_max))."""
        if slow_every is not None:
            return self._make_schedule_patterned(steps, rng, slow_every,
                                                 expensive_blocks)
        nb = len(self.block_sizes)
        blocks = np.empty(steps, np.int32)
        dirs = np.empty(steps, np.int32)

        # cyclic randomizers: over all-dirs, slow-dirs, fast-dirs
        def cycler(n):
            while True:
                perm = rng.permutation(n)
                for v in perm:
                    yield int(v)
        all_cyc = cycler(self.n)
        slow_cyc = cycler(self.n_slow) if self.n_slow else None
        nfast = self.n - self.n_slow
        fast_cyc = cycler(nfast) if nfast else None

        # map a position in block-order to (block, within-block handled by
        # per-block direction cycling below)
        pos_to_block = np.empty(self.n, np.int32)
        for b, (s, size) in enumerate(zip(self.block_starts, self.block_sizes)):
            pos_to_block[s:s + size] = b

        rot_ix = np.empty(steps, np.int32)
        # rotations restart each segment (drawn at once per segment); the
        # direction cycle within each rotation is preserved
        dir_count = np.zeros(len(self.block_sizes), np.int64)
        fast_ix = 0
        for t in range(steps):
            if fast_ix > 0:
                use_fast = True
                fast_ix -= 1
            else:
                pick = next(all_cyc)
                use_fast = pick >= self.n_slow and nfast > 0
                if use_fast:
                    fast_ix = self.oversample_fast - 1
            if use_fast:
                pos = self.n_slow + next(fast_cyc)
            else:
                pos = next(slow_cyc) if slow_cyc else next(fast_cyc)
            b = int(pos_to_block[pos])
            size = self.block_sizes[b]
            d = int(dir_count[b] % size)
            rot_ix[t] = dir_count[b] // size
            dir_count[b] += 1
            blocks[t] = b
            dirs[t] = d
        # deterministic upper bound, so segments of the same length draw the
        # same number of rotations: visits_b <= steps
        num_rots = tuple(steps // sz + 1 for sz in self.block_sizes)
        return ProposalSchedule(blocks, dirs, rot_ix, num_rots)

    def _make_schedule_patterned(self, steps, rng, slow_every,
                                 expensive_blocks):
        if expensive_blocks is None:
            expensive_blocks = list(range(self.slow_block_max))
        exp = set(int(b) for b in expensive_blocks)
        pos_block = []
        for b, (s, size) in enumerate(zip(self.block_starts, self.block_sizes)):
            pos_block += [b] * size
        exp_pos = [p for p, b in enumerate(pos_block) if b in exp]
        cheap_pos = [p for p, b in enumerate(pos_block) if b not in exp]
        if not exp_pos or not cheap_pos:
            raise ValueError("patterned schedule needs both expensive and "
                             "cheap directions")

        def cycler(items):
            while True:
                for v in rng.permutation(len(items)):
                    yield items[int(v)]
        e_cyc = cycler(exp_pos)
        c_cyc = cycler(cheap_pos)

        blocks = np.empty(steps, np.int32)
        dirs = np.empty(steps, np.int32)
        rot_ix = np.empty(steps, np.int32)
        dir_count = np.zeros(len(self.block_sizes), np.int64)
        for t in range(steps):
            pos = next(e_cyc) if t % slow_every == 0 else next(c_cyc)
            b = pos_block[pos]
            size = self.block_sizes[b]
            d = int(dir_count[b] % size)
            rot_ix[t] = dir_count[b] // size
            dir_count[b] += 1
            blocks[t] = b
            dirs[t] = d
        num_rots = tuple(steps // sz + 1 for sz in self.block_sizes)
        return ProposalSchedule(blocks, dirs, rot_ix, num_rots)

    # ---------- device-side proposal ----------

    def segment_rotations(self, gen: torch.Generator, nchains: int,
                          num_rots: Tuple[int, ...], device) -> List[torch.Tensor]:
        """Every rotation a segment needs, per block: (C, nr, size, size)."""
        return [random_rotation(gen, nchains * nr, sz, device).reshape(
                    nchains, nr, sz, sz)
                for nr, sz in zip(num_rots, self.block_sizes)]

    def segment_deltas(self, gen: torch.Generator, nchains: int,
                       schedule: ProposalSchedule, mapping: torch.Tensor,
                       dtype) -> torch.Tensor:
        """The unit-radius proposal direction of every step of a segment,
        (S, C, n) in varying order (proposal.py:segment_deltas)."""
        device = mapping.device
        S = len(schedule.block)
        seg_rots = self.segment_rotations(gen, nchains, schedule.num_rots,
                                          device)
        block = torch.as_tensor(np.asarray(schedule.block), device=device)
        direction = torch.as_tensor(np.asarray(schedule.direction),
                                    dtype=torch.int64, device=device)
        rot_index = torch.as_tensor(np.asarray(schedule.rot_index),
                                    dtype=torch.int64, device=device)
        out = torch.zeros(S, nchains, self.n, dtype=dtype, device=device)
        for b, (s, size) in enumerate(zip(self.block_starts, self.block_sizes)):
            rb = seg_rots[b]                                  # (C, nr, sz, sz)
            ri = torch.clamp(rot_index, max=rb.shape[1] - 1)
            di = torch.clamp(direction, max=size - 1)
            cols = rb[:, ri, :, di].to(dtype)                 # (S, C, sz)
            Mb = mapping[:, s:s + size].to(dtype)             # (n, sz)
            d = torch.einsum("scp,np->scn", cols, Mb)
            out = torch.where((block == b)[:, None, None], d, out)
        return out[:, :, torch.as_tensor(self.inv_order, device=device)]

    def schedule_radius_dims(self, schedule: ProposalSchedule) -> np.ndarray:
        """Static per-step min(block_dim, 2) for the radius mixture."""
        sizes = np.asarray(self.block_sizes)
        return np.minimum(sizes[np.asarray(schedule.block)], 2).astype(np.int32)

    def propose_step(self, P: torch.Tensor, delta_dir: torch.Tensor,
                     radius: torch.Tensor) -> torch.Tensor:
        """trial = P + r * scale * delta, per chain."""
        return P + delta_dir * (radius * self.propose_scale)[:, None]


def random_rotation(gen: torch.Generator, nchains: int, n: int,
                    device=None) -> torch.Tensor:
    """Batch of Haar random orthogonal matrices (nchains, n, n), float32:
    classical Gram-Schmidt, twice, on Gaussian columns (RandRotation)."""
    if n == 1:
        u = torch.rand(nchains, 1, 1, generator=gen, device=device)
        return torch.where(u < 0.5, 1.0, -1.0).to(torch.float32)
    g = torch.randn(n, nchains, n, generator=gen, device=device,
                    dtype=torch.float32)
    Q = torch.zeros(nchains, n, n, dtype=torch.float32, device=device)
    for j in range(n):
        v = g[j]
        for _ in range(2):
            coef = torch.einsum("cni,cn->ci", Q, v)
            v = v - torch.einsum("cni,ci->cn", Q, coef)
        Q[:, :, j] = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return Q


def propose_radius(gen: torch.Generator, m2: torch.Tensor, nchains: int,
                   dtype, device=None) -> torch.Tensor:
    """Radius mixture (propose.f90 Propose_r): w.p. 1/3 an Exp(1) draw,
    else the rms of min(block_dim, 2) = m2 standard normals."""
    use_exp = torch.rand(nchains, generator=gen, device=device) < (1.0 / 3.0)
    r_exp = torch.empty(nchains, dtype=dtype, device=device).exponential_(
        generator=gen)
    g = torch.randn(nchains, 2, generator=gen, dtype=dtype, device=device)
    m2f = m2.to(dtype)
    use2 = (m2f > 1.5).to(dtype)
    r_gauss = torch.sqrt((g[:, 0] ** 2 + use2 * g[:, 1] ** 2) / m2f)
    return torch.where(use_exp, r_exp, r_gauss)
