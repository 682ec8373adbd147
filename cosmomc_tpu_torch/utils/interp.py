"""Interpolation: linear (jnp.interp semantics), cubic splines (natural or
clamped ends) and Catmull-Rom bicubic grids.

Every function is batched over leading axes: knots `x` may be shared (n,)
or per chain (..., n), values are (..., n). The tridiagonal spline solve
(`_thomas`) is a Python loop over the n knots on (...,)-shaped tensors:
n is ~100 for the C_l fill, so the loop is cheap next to the work around it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation with `jnp.interp`'s arithmetic: the bracketing
    interval comes from a right-sided search clipped to [1, n-1], the value
    is fp[i-1] + (x - xp[i-1]) / dx * df, and points outside [xp[0], xp[-1]]
    take the end values. `xp`/`fp` are (n,) or (..., n) with the same
    leading axes as `x` (..., m)."""
    n = xp.shape[-1]
    if xp.dim() == 1 and fp.dim() == 1:
        i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, n - 1)
        f_hi, f_lo, x_hi, x_lo = fp[i], fp[i - 1], xp[i], xp[i - 1]
        first, last, x0, xn = fp[0], fp[-1], xp[0], xp[-1]
    else:
        lead = torch.broadcast_shapes(xp.shape[:-1], fp.shape[:-1],
                                      x.shape[:-1])
        xp = xp.expand(lead + (n,)).contiguous()
        fp = fp.expand(lead + (n,))
        x = x.expand(lead + x.shape[-1:]).contiguous()
        i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
        f_hi, f_lo = fp.gather(-1, i), fp.gather(-1, i - 1)
        x_hi, x_lo = xp.gather(-1, i), xp.gather(-1, i - 1)
        first, last = fp[..., :1], fp[..., -1:]
        x0, xn = xp[..., :1], xp[..., -1:]
    df = f_hi - f_lo
    dx = x_hi - x_lo
    delta = x - x_lo
    eps = torch.finfo(dx.dtype).eps
    dx0 = dx.abs() <= eps * eps               # np.spacing(eps)
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < x0, first, f)
    return torch.where(x > xn, last, f)


def gradient(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`jnp.gradient(f, x)` along the last axis with non-uniform spacing:
    second-order interior stencil, first-order one-sided ends."""
    upper = (f[..., 1:2] - f[..., 0:1]) / (x[..., 1:2] - x[..., 0:1])
    lower = (f[..., -1:] - f[..., -2:-1]) / (x[..., -1:] - x[..., -2:-1])
    dx1 = x[..., 1:-1] - x[..., :-2]
    dx2 = x[..., 2:] - x[..., 1:-1]
    a = -dx2 / (dx1 * (dx1 + dx2))
    b = (dx2 - dx1) / (dx1 * dx2)
    c = dx1 / (dx2 * (dx1 + dx2))
    inner = a * f[..., :-2] + b * f[..., 1:-1] + c * f[..., 2:]
    return torch.cat([upper, inner, lower], dim=-1)


def trapezoid(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`jnp.trapezoid(y, x)` along the last axis."""
    dx = x[..., 1:] - x[..., :-1]
    return 0.5 * (dx * (y[..., 1:] + y[..., :-1])).sum(-1)


def cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative sum accumulated in float64, returned in x's dtype. The
    tables summed here have up to ~8e3 entries: a float32 running sum
    loses ~n eps ~ 2e-4 over 4096 terms (measured on tau0), where the JAX
    package's log-depth scan loses ~log2(n) eps; float64 accumulation is
    below both."""
    return torch.cumsum(x.to(torch.float64), dim).to(x.dtype)


def _thomas(dl, d, du, b):
    """Solve tridiagonal systems (sub/main/super diagonals dl, d, du; dl[0]
    and du[-1] ignored), batched over leading axes; forward sweep and back
    substitution in the order of the JAX scan."""
    n = d.shape[-1]
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    cps, dps = [], []
    cp = torch.zeros_like(d[..., 0])
    dp = torch.zeros_like(d[..., 0])
    for i in range(n):
        a_i = dl[..., i] if i > 0 else torch.zeros_like(cp)
        denom = d[..., i] - a_i * cp
        cp = du[..., i] / denom
        dp = (b[..., i] - a_i * dp) / denom
        cps.append(cp)
        dps.append(dp)
    xs = [None] * n
    x_next = torch.zeros_like(cp)
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs, dim=-1)


class Spline(NamedTuple):
    """Natural cubic spline y(x) on knots x (strictly increasing)."""
    x: torch.Tensor   # (n,) or (..., n)
    y: torch.Tensor   # (..., n)
    y2: torch.Tensor  # (..., n) second derivatives at knots


def spline_fit(x: torch.Tensor, y: torch.Tensor, bc_start: float | None = None,
               bc_end: float | None = None) -> Spline:
    """Cubic spline through (x, y) (TCubicSpline%Init contract): natural
    ends, or clamped to the first derivative bc_start / bc_end."""
    h = x[..., 1:] - x[..., :-1]
    dy = (y[..., 1:] - y[..., :-1]) / h
    zero = torch.zeros_like(h[..., :1])
    one = torch.ones_like(h[..., :1])
    zb = torch.zeros_like(dy[..., :1])
    if bc_start is None:
        d0, du0, b0 = one, zero, zb
    else:   # 2 h0 y2[0] + h0 y2[1] = 6 (dy0 - bc_start)
        d0, du0, b0 = 2.0 * h[..., :1], h[..., :1], 6.0 * (dy[..., :1] - bc_start)
    if bc_end is None:
        dn, dln, bn = one, zero, zb
    else:
        dn, dln, bn = (2.0 * h[..., -1:], h[..., -1:],
                       6.0 * (bc_end - dy[..., -1:]))
    dl = torch.cat([zero, h[..., :-1], dln], dim=-1)
    du = torch.cat([du0, h[..., 1:], zero], dim=-1)
    d = torch.cat([d0, 2.0 * (h[..., :-1] + h[..., 1:]), dn], dim=-1)
    b = torch.cat([b0, 6.0 * (dy[..., 1:] - dy[..., :-1]), bn], dim=-1)
    return Spline(x, y, _thomas(dl, d, du, b))


def _segments(sp: Spline, xq: torch.Tensor):
    """The bracketing knot interval of each query: (a, b, h, y_l, y_r, y2_l,
    y2_r). Knots are shared (n,); queries are shared (m,) or per row
    (..., m), broadcast against the values' leading axes (..., n)."""
    x, y, y2 = sp
    n = x.shape[-1]
    i = (torch.searchsorted(x, xq.contiguous(), right=True) - 1).clamp(0, n - 2)
    xl, xr = x[i], x[i + 1]
    h = xr - xl
    if xq.dim() > 1 and y.dim() > 1:
        lead = torch.broadcast_shapes(y.shape[:-1], xq.shape[:-1])
        take = lambda v, j: v.expand(lead + v.shape[-1:]).gather(
            -1, j.expand(lead + j.shape[-1:]))
    else:
        take = lambda v, j: v[..., j]
    return ((xr - xq) / h, (xq - xl) / h, h, take(y, i), take(y, i + 1),
            take(y2, i), take(y2, i + 1))


def spline_eval(sp: Spline, xq: torch.Tensor) -> torch.Tensor:
    """Evaluate at xq; knots shared (n,), values (..., n), queries shared
    (m,) or per row (..., m)."""
    a, b, h, yl, yr, y2l, y2r = _segments(sp, xq)
    return (a * yl + b * yr
            + ((a ** 3 - a) * y2l + (b ** 3 - b) * y2r) * h ** 2 / 6.0)


def spline_eval_deriv(sp: Spline, xq: torch.Tensor) -> torch.Tensor:
    """dy/dx of the spline at xq (shapes as spline_eval)."""
    a, b, h, yl, yr, y2l, y2r = _segments(sp, xq)
    return ((yr - yl) / h
            + ((3 * b ** 2 - 1) * y2r - (3 * a ** 2 - 1) * y2l) * h / 6.0)


def spline_integral(sp: Spline) -> torch.Tensor:
    """Exact integral of the spline over its full range, (...,)."""
    x, y, y2 = sp
    h = x[..., 1:] - x[..., :-1]
    return torch.sum(h * (y[..., :-1] + y[..., 1:]) / 2.0
                     - h ** 3 * (y2[..., :-1] + y2[..., 1:]) / 24.0, -1)


def spline_cumint(sp: Spline) -> torch.Tensor:
    """Cumulative integral at each knot (starts at 0)."""
    x, y, y2 = sp
    h = x[..., 1:] - x[..., :-1]
    seg = h * (y[..., :-1] + y[..., 1:]) / 2.0 \
        - h ** 3 * (y2[..., :-1] + y2[..., 1:]) / 24.0
    return torch.cat([torch.zeros_like(seg[..., :1]), cumsum(seg)], -1)


def linspace(start, stop, num: int, dtype=None, device=None) -> torch.Tensor:
    """`jnp.linspace` arithmetic: start (1 - i/d) + stop i/d, last = stop.
    `start`/`stop` may be floats or (C,) tensors (result (C, num))."""
    ref = start if torch.is_tensor(start) else stop
    if torch.is_tensor(ref):
        dtype, device = ref.dtype, ref.device
    step = torch.arange(num - 1, dtype=dtype, device=device) / float(num - 1)
    s = start[..., None] if torch.is_tensor(start) else start
    e = stop[..., None] if torch.is_tensor(stop) else stop
    out = s * (1 - step) + e * step
    last = (stop[..., None] if torch.is_tensor(stop)
            else torch.full(out.shape[:-1] + (1,), stop, dtype=dtype,
                            device=device))
    return torch.cat([out, last.to(out.dtype).expand(out.shape[:-1] + (1,))],
                     -1)


class Grid2D(NamedTuple):
    """Values z (nx, ny) on regular axes x (nx,), y (ny,)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _cubic_weights(t: torch.Tensor):
    """Catmull-Rom weights for the fractional position t in [0, 1]."""
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)


def grid2d_eval(g: Grid2D, xq: torch.Tensor, yq: torch.Tensor) -> torch.Tensor:
    """Bicubic (Catmull-Rom) interpolation at query points of any shape,
    clamped at the edges (TInterpGrid2D's role, JAX interp.py:149-188)."""
    nx, ny = g.z.shape
    fx = (xq - g.x[0]) / (g.x[1] - g.x[0])
    fy = (yq - g.y[0]) / (g.y[1] - g.y[0])
    ix = torch.floor(fx).to(torch.int64).clamp(0, nx - 2)
    iy = torch.floor(fy).to(torch.int64).clamp(0, ny - 2)
    wx = _cubic_weights((fx - ix.to(fx.dtype)).clamp(0.0, 1.0))
    wy = _cubic_weights((fy - iy.to(fy.dtype)).clamp(0.0, 1.0))
    out = torch.zeros_like(wx[0])
    for di in range(4):
        row = torch.zeros_like(wx[0])
        for dj in range(4):
            row = row + wy[dj] * g.z[(ix + di - 1).clamp(0, nx - 1),
                                     (iy + dj - 1).clamp(0, ny - 1)]
        out = out + wx[di] * row
    return out


def linear_interp(x: torch.Tensor, xp: torch.Tensor,
                  fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation on sorted xp, clamped at the ends (JAX
    interp.py:191-193): `interp`."""
    return interp(x, xp, fp)
