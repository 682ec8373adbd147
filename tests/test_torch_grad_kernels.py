"""The reverse kernels against autograd of their plain versions, on the
card (K4, K1 in its four instantiations, K2a, K3, K5, K6). Every test here needs an NVIDIA GPU and nvcc and
skips without them; run on the card with

    python -m pytest tests/test_torch_grad_kernels.py -q --noconftest

(this file imports neither jax nor cosmomc_tpu). Both versions see the
same inputs and the same seeded cotangents on the card, at small shapes
(chip_smoke.py phase 2 holds them at the main path's): float64 within 1e-9
of each gradient's largest magnitude; float32 against the float64 plain
gradient within the bound stated in each test.
"""

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.reionization import zre_from_tau

pytestmark = pytest.mark.cuda
F64, F32 = torch.float64, torch.float32


def rel_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cosmo(dev):
    C = 2
    bg = BackgroundParams.make(ombh2=np.linspace(0.0215, 0.0232, C),
                               omch2=np.linspace(0.115, 0.125, C),
                               H0=np.linspace(66.0, 69.0, C), nchains=C,
                               device=dev, dtype=F64)
    yhe = torch.linspace(0.242, 0.248, C, dtype=F64, device=dev)
    return bg, yhe


def test_recfast_reverse_kernel(dev, cosmo):
    bg, yhe = cosmo
    fHe = yhe / (const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt = trec._z_tables(bg, trec.z_grid(1000, dev, F64), fHe,
                        Nnow).float().double().contiguous()
    fHe = fHe.float().double()
    g = torch.Generator(device="cpu").manual_seed(4)
    gxe = torch.randn(2, 1000, generator=g, dtype=F64).to(dev)
    gtm = 1e-3 * torch.randn(2, 1000, generator=g, dtype=F64).to(dev)
    z, f = zt.clone().requires_grad_(True), fHe.clone().requires_grad_(True)
    xe, tm = trec._scan_plain(z, f)
    ref = torch.autograd.grad((xe * gxe).sum() + (tm * gtm).sum(), [z, f])
    for dt, tol in ((F64, 1e-9), (F32, 1e-4)):
        kernels.reset_launches()
        z = zt.to(dt).requires_grad_(True)
        f = fHe.to(dt).requires_grad_(True)
        xe, tm = trec._scan_cuda(z, f)
        got = torch.autograd.grad((xe * gxe.to(dt)).sum()
                                  + (tm * gtm.to(dt)).sum(), [z, f])
        assert kernels.launches["recfast"] == 1
        assert kernels.launches["recfast_bwd"] == 1
        for a, b in zip(got, ref):
            assert bool(torch.isfinite(a).all())
            assert rel_err(a, b) <= tol, (dt, rel_err(a, b))


@pytest.mark.parametrize("chunks", [4, 0])
def test_boltzmann_reverse_kernel(dev, cosmo, chunks):
    """256 steps, 16 k to 0.02/Mpc on a grid built for kmax 0.1, the
    radiation-streaming switch at k tau = 40 (bounded lanes that switch; the
    plain version's loop sets the size), an isocurvature amplitude on one
    chain; 0 chunks takes the wrapper's default."""
    bg, yhe = cosmo
    with torch.no_grad():
        th = trec.compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64, device=dev),
                           yhe)
        tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=257,
                                         kmax=0.1)
        q = tpert._stage_tables(bg, tf).float().double().contiguous()
    k = torch.as_tensor(np.geomspace(5e-4, 0.02, 16), dtype=F64, device=dev)
    rnu = tpert._r_nu(bg).float().double().contiguous()
    iso = torch.tensor([[0.2, 1.3, 0.84], [0.0, 1.3, 0.84]], dtype=F64,
                       device=dev)
    g = torch.Generator(device="cpu").manual_seed(5)
    gout = torch.randn(7, 2, q.shape[1], 16, generator=g, dtype=F64).to(dev)
    qq, rr, ii = (t.clone().requires_grad_(True) for t in (q, rnu, iso))
    o = tpert._evolve_plain(qq, k, rr, 40.0, iso=ii, remat_chunks=chunks)
    ref = torch.autograd.grad((o * gout).sum(), [qq, rr, ii])
    for dt, tol in ((F64, 1e-9), (F32, 1e-3)):
        kernels.reset_launches()
        qk, rk, ik = (t.to(dt).requires_grad_(True) for t in (q, rnu, iso))
        ok = tpert._evolve_cuda(qk, k.to(dt), rk, 40.0, iso=ik,
                                remat_chunks=chunks)
        assert rel_err(ok, o) <= (1e-9 if dt == F64 else 1e-3)
        got = torch.autograd.grad((ok * gout.to(dt)).sum(), [qk, rk, ik])
        assert kernels.launches["boltzmann"] == 1
        assert kernels.launches["boltzmann_bwd"] == 1
        for a, b in zip(got, ref):
            assert bool(torch.isfinite(a).all())
            assert rel_err(a, b) <= tol, (dt, rel_err(a, b))


def test_reverse_kernels_are_deterministic(dev, cosmo):
    """The table's cotangent is summed over the k lanes in a fixed order:
    two runs give the same bits."""
    bg, yhe = cosmo
    with torch.no_grad():
        th = trec.compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64, device=dev),
                           yhe)
        tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=129,
                                         kmax=0.1)
        q = tpert._stage_tables(bg, tf).contiguous()
    k = torch.as_tensor(np.geomspace(5e-4, 0.02, 300), dtype=F64, device=dev)
    rnu = tpert._r_nu(bg).contiguous()
    gout = torch.ones(7, 2, q.shape[1], 300, dtype=F64, device=dev)
    runs = []
    for _ in range(2):
        qk = q.clone().requires_grad_(True)
        o = tpert._evolve_cuda(qk, k, rnu, 40.0, remat_chunks=8)
        runs.append(torch.autograd.grad((o * gout).sum(), qk)[0])
    assert torch.equal(runs[0], runs[1])


EXTENDED = {"nu": (True, False), "de": (False, True), "nu_de": (True, True)}


def _extended_inputs(dev, sw, nk, n_step):
    """Two chains with mnu 0.1 / 0.3 eV, w0 -0.9 / -1.1, wa -0.4 / 0.2, an
    isocurvature amplitude on the first: the stage table of the
    instantiation `sw` on a grid built for kmax 0.1, nk k to 0.02/Mpc."""
    from cosmomc_tpu_torch.params.parameterizations import mnu_to_omnuh2
    bg = BackgroundParams.make(
        ombh2=np.array([0.0221, 0.0226]), omch2=np.array([0.118, 0.122]),
        H0=np.array([67.0, 68.0]), omnuh2=mnu_to_omnuh2(np.array([0.1, 0.3])),
        w=np.array([-0.9, -1.1]), wa=np.array([-0.4, 0.2]), nchains=2,
        device=dev, dtype=F64)
    yhe = torch.full((2,), 0.245, dtype=F64, device=dev)
    with torch.no_grad():
        th = trec.compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64, device=dev),
                           yhe)
        tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=n_step,
                                         kmax=0.1)
        q = tpert._stage_tables(bg, tf, *sw).float().double().contiguous()
    k = torch.as_tensor(np.geomspace(5e-4, 0.02, nk), dtype=F64, device=dev)
    iso = tpert.iso_inputs(bg, torch.tensor([0.2, 0.0], dtype=F64, device=dev))
    return q, k, tpert._r_nu(bg).float().double().contiguous(), iso


@pytest.mark.parametrize("variant", list(EXTENDED))
def test_extended_reverse_kernels(dev, variant):
    """K1's extended instantiations' reverse kernels, as
    test_boltzmann_reverse_kernel: 256 steps, 16 k, rsa_ktau 40, 4 chunks,
    against autograd of the plain version on the card."""
    sw = EXTENDED[variant]
    q, k, rnu, iso = _extended_inputs(dev, sw, 16, 257)
    g = torch.Generator(device="cpu").manual_seed(6)
    gout = torch.randn(7, 2, q.shape[1], 16, generator=g, dtype=F64).to(dev)
    qq, rr, ii = (t.clone().requires_grad_(True) for t in (q, rnu, iso))
    o = tpert._evolve_plain(qq, k, rr, 40.0, *sw, iso=ii, remat_chunks=4)
    ref = torch.autograd.grad((o * gout).sum(), [qq, rr, ii])
    name = tpert.VARIANTS[sw]
    for dt, tol in ((F64, 1e-9), (F32, 1e-3)):
        kernels.reset_launches()
        qk, rk, ik = (t.to(dt).requires_grad_(True) for t in (q, rnu, iso))
        ok = tpert._evolve_cuda(qk, k.to(dt), rk, 40.0, *sw, iso=ik,
                                remat_chunks=4)
        assert rel_err(ok, o) <= (1e-9 if dt == F64 else 1e-3)
        got = torch.autograd.grad((ok * gout.to(dt)).sum(), [qk, rk, ik])
        assert kernels.launches[name] == 1
        assert kernels.launches[f"{name}_bwd"] == 1
        for a, b in zip(got, ref):
            assert bool(torch.isfinite(a).all())
            assert rel_err(a, b) <= tol, (variant, dt, rel_err(a, b))


@pytest.mark.parametrize("variant", list(EXTENDED))
def test_extended_reverse_kernels_are_deterministic(dev, variant):
    """Two gradients through an extended instantiation, 300 k lanes (two
    blocks a chain), give the same bits."""
    sw = EXTENDED[variant]
    q, k, rnu, iso = _extended_inputs(dev, sw, 300, 129)
    gout = torch.ones(7, 2, q.shape[1], 300, dtype=F64, device=dev)
    runs = []
    for _ in range(2):
        xs = [t.clone().requires_grad_(True) for t in (q, rnu, iso)]
        o = tpert._evolve_cuda(xs[0], k, xs[1], 40.0, *sw, iso=xs[2],
                               remat_chunks=8)
        runs.append(torch.autograd.grad((o * gout).sum(), xs))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_no_second_derivative(dev, cosmo):
    """The reverse kernels have no derivative of their own: a second
    derivative raises instead of coming back wrong."""
    bg, yhe = cosmo
    fHe = yhe / (const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt = trec._z_tables(bg, trec.z_grid(200, dev, F64), fHe,
                        Nnow).contiguous().requires_grad_(True)
    xe, _ = trec._scan_cuda(zt, fHe)
    (g,) = torch.autograd.grad(xe.sum(), zt, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), zt)


def test_los_reverse_kernel(dev):
    """K2a's reverse (los_bwd) through `_Los` against autograd of
    `_los_plan_plain`: 2 chains, 24 coarse k to 0.05/Mpc, 128 tau nodes,
    lmax 600, the second chain's last node at x = 0."""
    from cosmomc_tpu_torch.models import cls as tcls
    kgrid = np.geomspace(2e-4, 0.05, 24)
    key = (600, 14200.0, 0.05, 4.0, 256, tuple(kgrid.tolist()))
    plan = tcls._plan(*key)
    g = torch.Generator(device="cpu").manual_seed(5)
    C, nt = 2, 128
    tau = torch.linspace(200.0, 14000.0, nt, dtype=F64)
    kk = torch.as_tensor(kgrid)[:, None]
    src = torch.stack([torch.exp(-((tau - 280.0) / 40.0) ** 2)
                       * torch.cos(kk * tau / (3.0 + i)) for i in range(4)])
    src = torch.stack([src, 1.1 * src]).float().double().to(dev).contiguous()
    chi = (torch.tensor([[14100.0], [14000.0]], dtype=F64) - tau).to(dev)
    chi[1, -1] = 0.0
    wt = torch.full((C, nt), float(tau[1] - tau[0]), dtype=F64, device=dev)
    wl = 1e-4 * wt
    dp64 = tcls._device_plan(key, str(src.device), F64)
    G = torch.randn(3, C, *dp64["ls"].shape, dp64["kf"].shape[0],
                    generator=g, dtype=F64).to(dev)
    inv_dx = 1.0 / plan.dx
    xs = [t.clone().requires_grad_(True) for t in (src, chi, wt, wl)]
    ref = torch.autograd.grad((tcls._los_plan_plain(xs[0], dp64, *xs[1:], inv_dx)
                               * G).sum(), xs)
    for dt, tol in ((F64, 1e-9), (F32, 1e-3)):
        dp = tcls._device_plan(key, str(src.device), dt)
        kernels.reset_launches()
        xs = [t.to(dt).requires_grad_(True) for t in (src, chi, wt, wl)]
        out = tcls._Los.apply(*xs, dp, float(torch.tensor(inv_dx, dtype=dt)))
        got = torch.autograd.grad((out * G.to(dt)).sum(), xs)
        assert kernels.launches["los"] == 1 and kernels.launches["los_bwd"] == 1
        for a, b in zip(got, ref):
            assert bool(torch.isfinite(a).all())
            assert rel_err(a, b) <= tol, (dt, rel_err(a, b))


def test_lensing_reverse_kernel(dev):
    """K3's reverse (lensing_bwd) through `_Lensing` against autograd of
    `_passes_plain`: 2 chains, l 2..600 -> 450, 1200 theta."""
    from cosmomc_tpu_torch.models import lensing as tlens
    L = 599
    l = np.arange(2, L + 2, dtype=np.float64)
    cl = []
    for a in (1.0, 1.1):
        damp = np.exp(-(l / 1400.0) ** 2)
        tt = a * 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0) ** 2)
        ee = a * 40.0 * damp * (l / 1000.0) * (1 + np.sin(np.pi * l / 300.0) ** 2)
        te = 0.4 * np.sqrt(tt * ee) * np.cos(np.pi * l / 150.0)
        pp = a * 1.8e-7 * (l / 40.0) / (1.0 + (l / 40.0) ** 2) ** 1.2
        cl.append(tlens.lens_inputs(torch.as_tensor(l), *(torch.as_tensor(x)[None]
                                                          for x in (tt, te, ee, pp)))[0])
    cl = torch.stack(cl).float().double().to(dev)
    n_theta, nl_out = 2 * (L + 1), 449
    gs = torch.randn(2, nl_out, 4, generator=torch.Generator().manual_seed(6),
                     dtype=F64).to(dev)
    x = cl.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad((tlens._passes_grid_plain(x, n_theta, True, nl_out)
                                  * gs).sum(), [x])
    for dt, tol in ((F64, 1e-9), (F32, 1e-5)):
        kernels.reset_launches()
        x = cl.to(dt).requires_grad_(True)
        (got,) = torch.autograd.grad((tlens._passes_cuda(x, n_theta, True, nl_out)
                                      * gs.to(dt)).sum(), [x])
        assert kernels.launches["lensing"] == 1
        assert kernels.launches["lensing_bwd"] == 1
        for q in range(4):
            assert rel_err(got[:, q], ref[:, q]) <= tol, (dt, q)


@pytest.mark.parametrize("substeps,chunks", [(1, 6), (2, 0)])
def test_tensors_reverse_kernel(dev, cosmo, substeps, chunks):
    """K5's reverse (tensors_bwd) through `_Tensors` against autograd of
    `_evolve_t_plain`: 2 chains, 16 tensor k, the 1023 steps of a
    1024-node grid (tight coupling, held lanes, the freeze of the top k),
    1 and 2 substeps; 0 chunks takes the wrapper's default."""
    from cosmomc_tpu_torch.models import tensors as tten
    bg, yhe = cosmo
    with torch.no_grad():
        th = trec.compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64, device=dev),
                           yhe)
        tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=1024)
        q = tten._stage_table(bg, tf, substeps).float().double().contiguous()
    k = torch.as_tensor(tten.tensor_k_grid(nk=16), dtype=F64, device=dev)
    gout = torch.randn(3, 2, q.shape[1], 16, generator=torch.Generator().manual_seed(7),
                       dtype=F64).to(dev)
    qq = q.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad((tten._evolve_t_plain(qq, k, substeps, True, 8)
                                  * gout).sum(), [qq])
    for dt, tol in ((F64, 1e-9), (F32, 1e-5)):
        kernels.reset_launches()
        qk = q.to(dt).requires_grad_(True)
        (got,) = torch.autograd.grad((tten._evolve_t_cuda(qk, k.to(dt), substeps, True,
                                                          chunks) * gout.to(dt)).sum(),
                                     [qk])
        assert kernels.launches["tensors"] == 1
        assert kernels.launches["tensors_bwd"] == 1
        assert bool(torch.isfinite(got).all())
        assert rel_err(got, ref) <= tol, (dt, rel_err(got, ref))


def test_tensor_los_reverse_kernel(dev):
    """K6's reverse (tensor_los_bwd) through `_TensorLos` against autograd
    of `_tlos_plain`: 2 chains of smooth sources on 24 coarse k to
    0.03/Mpc, 256 tau nodes, lmax 300, the second chain's last node a few
    ulps below its tau0 (x < 1e-8). Float64 within 1e-9; float32 no less
    accurate than the plain version in float32 (the cotangent of chi at
    that node cancels in float32: the plain version's is 0.86% off on the
    CPU) or within 5e-5."""
    from cosmomc_tpu_torch.models import tensors as tten
    from cosmomc_tpu_torch.models.bessel import default_l_samples
    kmax, tau0_hint, nt = 0.03, 14700.0, 256
    coarse = tten.tensor_k_grid(kmax=kmax, nk=24)
    tau0 = torch.tensor([14100.0, 13950.0], dtype=F64)
    tau = torch.stack([torch.cat([torch.logspace(np.log10(200.0), np.log10(1200.0),
                                                 nt // 2, dtype=F64),
                                  torch.linspace(1300.0, float(t0) - 30.0, nt // 2,
                                                 dtype=F64)]) for t0 in tau0])
    tau[1, -1] = tau0[1] * (1 - 4e-16)
    kk = torch.as_tensor(coarse)[:, None]
    src = torch.stack([torch.stack([torch.exp(-((t - 280.0) / 60.0) ** 2)
                                    * torch.cos(kk * t / (3.0 + i)) for i in range(2)])
                       for t in tau]).float().double()
    G = None
    out = {}
    for dt in (F64, F32):
        grid = tten._tlos_grid(300, tau0_hint, kmax, 4.0, tuple(coarse.tolist()),
                               str(dev), dt)
        tabs = tten.tlos_tables(tuple(default_l_samples(300).tolist()),
                                kmax * tau0_hint * 1.02 + 10, dev)
        chi = (tau0[:, None] - tau).to(dev, dt)
        dtau = tau[:, 1:] - tau[:, :-1]
        wt = torch.cat([dtau[:, :1] / 2, (dtau[:, 1:] + dtau[:, :-1]) / 2,
                        dtau[:, -1:] / 2], 1).to(dev, dt)
        rest = (grid["lo"], grid["hi"], grid["w"], grid["kf"], tabs["jl"], tabs["jlp"],
                grid["ls"], float(torch.tensor(1.0 / tabs["dx"], dtype=dt)))
        if G is None:
            G = torch.randn(3, 2, grid["ls"].shape[0], grid["kf"].shape[0],
                            generator=torch.Generator().manual_seed(8),
                            dtype=F64).to(dev)
        xs = [t.clone().requires_grad_(True) for t in (src.to(dev, dt), chi, wt)]
        o = tten._tlos_plain(xs[0], *rest[:4], xs[1], xs[2], *rest[4:])
        out["plain", dt] = torch.autograd.grad((o * G.to(dt)).sum(), xs)
        xs = [t.detach().clone().requires_grad_(True) for t in xs]
        kernels.reset_launches()
        o = tten._TensorLos.apply(*xs, rest, grid)
        out[dt] = torch.autograd.grad((o * G.to(dt)).sum(), xs)
        assert kernels.launches["tensor_los"] == 1
        assert kernels.launches["tensor_los_bwd"] == 1
    for a, b, p in zip(out[F64], out["plain", F64], out["plain", F32]):
        assert bool(torch.isfinite(a).all())
        assert rel_err(a, b) <= 1e-9, rel_err(a, b)
    for a, b, p in zip(out[F32], out["plain", F64], out["plain", F32]):
        assert bool(torch.isfinite(a).all())
        assert rel_err(a, b) <= max(2.0 * rel_err(p, b), 5e-5), (rel_err(a, b),
                                                                  rel_err(p, b))
