"""Rematerialization of a piece of a plain loop's autograd graph.

`remat(fn, *args)` returns `fn(*args)` (a tuple of tensors) computed
without a graph; in the backward pass it runs `fn` again on the same
inputs with one and takes the vector-Jacobian product through it. The
graph of `fn` then lives only while its cotangent is computed, so a long
loop cut into chunks holds one chunk's graph at a time, plus the states
between chunks: what JAX's `remat` (jax.checkpoint) does for a scan.

torch.utils.checkpoint's non-reentrant form keeps every autograd node of
the chunk and frees only the tensors they save; where the loop's tensors
are a few numbers a chain (recfast's nodes, K1's steps on a handful of
lanes) the nodes are most of the memory, hence this form. Its backward
calls torch.autograd.grad on the recomputed graph, so it serves
torch.autograd.grad and backward() alike; it is once differentiable. The
recomputation repeats the same operations on the same inputs, so the
numbers do not change.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable


class _Remat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.is_tensor = [torch.is_tensor(a) for a in args]
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a, t in zip(args, ctx.is_tensor) if t))
        return tuple(fn(*args))

    @staticmethod
    @once_differentiable
    def backward(ctx, *g_out):
        saved = iter(ctx.saved_tensors)
        args, want = [], []
        for i, (a, t) in enumerate(zip(ctx.others, ctx.is_tensor)):
            if not t:
                args.append(a)
                continue
            x = next(saved).detach()
            if ctx.needs_input_grad[1 + i]:
                x.requires_grad_(True)
                want.append(i)
            args.append(x)
        with torch.enable_grad():
            outs = tuple(ctx.fn(*args))
        pairs = [(o, g if g is not None else torch.zeros_like(o))
                 for o, g in zip(outs, g_out) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], [args[i] for i in want],
                                    [g for _, g in pairs], allow_unused=True)
        out = [None] * len(args)
        for i, g in zip(want, grads):
            out[i] = g
        return (None, *out)


def remat(fn, *args):
    """fn(*args), a tuple of tensors, with its graph rematerialized in the
    backward pass (module docstring). Non-tensor arguments pass through."""
    return _Remat.apply(fn, *args)
