"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and nvcc and skips without
them; run on the card with

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(this file imports neither jax nor cosmomc_tpu, so it runs where only the
port is installed). Both versions see the same inputs on the same device.
float64: the kernel agrees with the plain version to 1e-9 of each array's
largest magnitude. float32: rounding and summation order differ, and some
outputs are small differences of large sums (lensed BB, late sources), so
the float32 kernel is held to the float64 plain result on the same
(float32-rounded) inputs, and must be no less accurate than the float32
plain version: err(kernel) <= max(2 err(plain), floor).
"""

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models import lensing as tlens
from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models import tensors as tten
from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.cmb import source_k_grid
from cosmomc_tpu_torch.models.reionization import zre_from_tau

pytestmark = pytest.mark.cuda
F64, F32 = torch.float64, torch.float32


def rel_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def check(kern, plain, ref64, dtype, floor, what=""):
    if dtype == F64:
        assert rel_err(kern, plain) <= 1e-9, what
    else:
        ek, ep = rel_err(kern, ref64), rel_err(plain, ref64)
        assert ek <= max(2.0 * ep, floor), (what, ek, ep)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bg(dev, dtype, C=2):
    return BackgroundParams.make(ombh2=np.linspace(0.0215, 0.0232, C),
                                 omch2=np.linspace(0.115, 0.125, C),
                                 H0=np.linspace(66.0, 69.0, C), nchains=C,
                                 device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_recfast_kernel(dev, dtype):
    bg = _bg(dev, F64)
    yhe = torch.full((2,), 0.245, dtype=F64, device=dev)
    fHe = yhe / (trec.const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = trec.const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt64 = trec._z_tables(bg, trec.z_grid(2000, dev, F64), fHe, Nnow).contiguous()
    zt, f = zt64.to(dtype), fHe.to(dtype)
    n0 = kernels.launches["recfast"]
    xe_k, tm_k = trec._scan_cuda(zt, f)
    torch.cuda.synchronize()
    assert kernels.launches["recfast"] == n0 + 1
    xe_p, tm_p = trec._scan_plain(zt, f)
    xe_r, tm_r = trec._scan_plain(zt.double(), f.double())
    check(xe_k, xe_p, xe_r, dtype, 1e-4, "xe")
    check(tm_k, tm_p, tm_r, dtype, 1e-4, "tm")


@pytest.mark.parametrize("chains,n_z", [(1, 2000), (3, 1000), (8, 977)])
def test_recfast_kernel_chain_counts(dev, chains, n_z):
    """One warp a chain: 1, 3 and 8 chains; 977 nodes leave the last
    32-node tile ragged, and each chain finds its own first live node."""
    bg = _bg(dev, F64, chains)
    yhe = torch.linspace(0.24, 0.25, chains, dtype=F64, device=dev)
    fHe = yhe / (trec.const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = trec.const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt = trec._z_tables(bg, trec.z_grid(n_z, dev, F64), fHe, Nnow).contiguous()
    assert 1 < int(trec.first_live_node(zt).min()) < n_z
    for dtype in (F64, F32):
        z, f = zt.to(dtype), fHe.to(dtype)
        k, p = trec._scan_cuda(z, f), trec._scan_plain(z, f)
        r = trec._scan_plain(z.double(), f.double())
        for a, b, c, n in zip(k, p, r, ("xe", "tm")):
            check(a, b, c, dtype, 1e-4, n)
    # a table that never leaves the Saha/hot regime is all prefix
    hot = zt[:, :, :40].contiguous()
    for a, b in zip(trec._scan_cuda(hot, fHe), trec._scan_plain(hot, fHe)):
        check(a, b, None, F64, 0.0, "all-prefix table")


@pytest.fixture(scope="module")
def tables(dev):
    """A 2048-step grid for two chains, and its stage tables. At 1024
    steps the top k lane sits at the edge of RK4 stability in float32, where
    the kernel's fused multiply-adds and the plain version's separate
    roundings flip a switch at different steps (on an H100: the plain version
    misses float64 by 2.2e-3 of the plane's maximum there, the kernel by
    2.5e-2, the kernel built without FMA contraction by 2.0e-3)."""
    bg = _bg(dev, F64)
    yhe = torch.full((2,), 0.245, dtype=F64, device=dev)
    th = trec.compute_thermo(bg, yhe, n_z=2000)
    zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64, device=dev), yhe)
    tf, tau0 = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=2048)
    k = torch.as_tensor(source_k_grid(0.1, 8, 16), dtype=F64, device=dev)
    return bg, tf, tau0, k, tpert._stage_tables(bg, tf), tpert._r_nu(bg)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_boltzmann_kernel(dev, tables, dtype):
    _, _, _, k, q, rnu = tables
    qd, kd, rd = q.to(dtype), k.to(dtype), rnu.to(dtype).contiguous()
    n0 = kernels.launches["boltzmann"]
    out_k = tpert._evolve_cuda(qd, kd, rd, tpert.RSA_KTAU)
    torch.cuda.synchronize()
    assert kernels.launches["boltzmann"] == n0 + 1
    assert torch.isfinite(out_k).all()
    out_p = tpert._evolve_plain(qd, kd, rd, tpert.RSA_KTAU)
    out_r = tpert._evolve_plain(qd.double(), kd.double(), rd.double(),
                                tpert.RSA_KTAU)
    for p, name in enumerate(tpert.PLANES):
        check(out_k[p], out_p[p], out_r[p], dtype, 1e-3, name)


@pytest.mark.parametrize("chains,nk,steps", [(1, 24, 2047), (2, 13, 500), (2, 1, 70)])
def test_boltzmann_kernel_ragged_blocks(dev, tables, chains, nk, steps):
    """One warp a (chain, k) lane in blocks of 8: one chain; 13 k (a last
    block of 5 warps) over 500 steps (a last tile of 4 steps); one lane."""
    _, _, _, k, q, rnu = tables
    for dtype in (F64, F32):
        qd = q[:chains, :steps].to(dtype).contiguous()
        kd, rd = k[-nk:].to(dtype).contiguous(), rnu[:chains].to(dtype).contiguous()
        out_k = tpert._evolve_cuda(qd, kd, rd, tpert.RSA_KTAU)
        out_p = tpert._evolve_plain(qd, kd, rd, tpert.RSA_KTAU)
        out_r = tpert._evolve_plain(qd.double(), kd.double(), rd.double(),
                                    tpert.RSA_KTAU)
        assert out_k.shape == (len(tpert.PLANES), chains, steps, nk)
        for p, name in enumerate(tpert.PLANES):
            check(out_k[p], out_p[p], out_r[p], dtype, 1e-3, name)


@pytest.fixture(scope="module")
def ext_tables(dev):
    """Two chains on the 2048-step grid with mnu 0.06 and 0.3 eV, w0 -0.9
    and -1.1, wa -0.4 (the w = -1 crossing) and 0.2, and isocurvature
    amplitudes 0.2 and 0: each variant's stage table, k to 0.1/Mpc."""
    from cosmomc_tpu_torch.params.parameterizations import mnu_to_omnuh2
    bg = BackgroundParams.make(ombh2=np.array([0.0224, 0.0219]),
                               omch2=np.array([0.120, 0.117]),
                               H0=np.array([67.5, 69.0]),
                               omnuh2=mnu_to_omnuh2(np.array([0.06, 0.3])),
                               w=np.array([-0.9, -1.1]), wa=np.array([-0.4, 0.2]),
                               nchains=2, device=dev, dtype=F64)
    yhe = torch.full((2,), 0.245, dtype=F64, device=dev)
    th = trec.compute_thermo(bg, yhe, n_z=2000)
    zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64, device=dev), yhe)
    tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=2048)
    k = torch.as_tensor(source_k_grid(0.1, 8, 16), dtype=F64, device=dev)
    iso = tpert.iso_inputs(bg, torch.tensor([0.2, 0.0], dtype=F64, device=dev))
    q = {sw: tpert._stage_tables(bg, tf, *sw) for sw in tpert.VARIANTS}
    return q, k, tpert._r_nu(bg), iso


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("sw", [(True, False), (False, True), (True, True),
                                (False, False)])
def test_boltzmann_extended_kernels(dev, ext_tables, sw, dtype):
    """Each instantiation (massive-neutrino hierarchy, DE fluid, both, and
    the base layout with an isocurvature chain) against its plain version:
    one launch counted on its own name; float64 1e-9, float32 no less
    accurate than plain float32 (floor 1e-3 of each plane's maximum)."""
    q, k, rnu, iso = ext_tables
    qd, kd, rd, id_ = (x.to(dtype).contiguous() for x in (q[sw], k, rnu, iso))
    name = tpert.VARIANTS[sw]
    n0 = dict(kernels.launches)
    out_k = tpert._evolve_cuda(qd, kd, rd, tpert.RSA_KTAU, *sw, iso=id_)
    torch.cuda.synchronize()
    assert {n: kernels.launches[n] - n0[n] for n in n0} == {
        n: int(n == name) for n in n0}
    assert torch.isfinite(out_k).all()
    out_p = tpert._evolve_plain(qd, kd, rd, tpert.RSA_KTAU, *sw, iso=id_)
    out_r = out_p if dtype == F64 else tpert._evolve_plain(
        qd.double(), kd.double(), rd.double(), tpert.RSA_KTAU, *sw, iso=id_.double())
    for p, pl in enumerate(tpert.PLANES):
        check(out_k[p], out_p[p], out_r[p], dtype, 1e-3, f"{name}.{pl}")


@pytest.mark.parametrize("sw", [(True, False), (False, True), (True, True)])
def test_boltzmann_extended_ragged(dev, ext_tables, sw):
    """The extended instantiations at one chain, 13 k (a last block of 5
    warps) and 500 steps (a last tile of 4 steps in float64), float64."""
    q, k, rnu, iso = ext_tables
    qd = q[sw][:1, :500].contiguous()
    kd, rd, id_ = k[-13:].contiguous(), rnu[:1].contiguous(), iso[:1].contiguous()
    out_k = tpert._evolve_cuda(qd, kd, rd, tpert.RSA_KTAU, *sw, iso=id_)
    out_p = tpert._evolve_plain(qd, kd, rd, tpert.RSA_KTAU, *sw, iso=id_)
    for p, pl in enumerate(tpert.PLANES):
        check(out_k[p], out_p[p], None, F64, 0.0, pl)


def _plain(module, name, twin=None):
    """Context that routes a module's CUDA path to its plain version (the
    function `twin`, by default the name with "plain" for "cuda")."""
    class Swap:
        def __enter__(self):
            self.real = getattr(module, name)
            setattr(module, name,
                    getattr(module, twin or name.replace("cuda", "plain")))

        def __exit__(self, *exc):
            setattr(module, name, self.real)
    return Swap()


@pytest.mark.parametrize("dtype", [F64, F32])
def test_los_kernel(dev, tables, dtype):
    """lmax 450: 60 sampled l after padding (not a multiple of a warp's 8);
    k_chunk 100 pads the fine k to a count that is not a multiple of the
    32-k block; tau stride 3 leaves 683 nodes (a ragged last tau tile)."""
    bg, tf, tau0, k, _, _ = tables
    po64 = tpert.evolve_perturbations(bg, tf, tau0, k)
    po = po64._replace(**{f: getattr(po64, f).to(dtype) for f in
                          ("tau", "k", "s0", "s1", "s2", "slens", "tau0")})
    args = dict(coarse_k=source_k_grid(0.1, 8, 16), lmax=450, kmax_hint=0.1,
                tau_stride=3, k_chunk=100)
    chi = (tau0 - 280.0).to(dtype)
    n0 = kernels.launches["los"]
    clt_k = tcls.compute_cl_transfers(po, chi, **args)
    again = tcls.compute_cl_transfers(po, chi, **args)
    torch.cuda.synchronize()
    assert kernels.launches["los"] == n0 + 2
    for f in ("dT", "dE", "dP"):
        assert torch.equal(getattr(clt_k, f), getattr(again, f)), f
    with _plain(tcls, "_los_cuda", "_los_plan_plain"):
        clt_p = tcls.compute_cl_transfers(po, chi, **args)
        po_r = po._replace(**{f: getattr(po, f).double() for f in
                              ("tau", "k", "s0", "s1", "s2", "slens", "tau0")})
        clt_r = tcls.compute_cl_transfers(po_r, chi.double(), **args)
    for f in ("dT", "dE", "dP"):
        check(getattr(clt_k, f), getattr(clt_p, f), getattr(clt_r, f), dtype,
              1e-4, f)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_los_rec_kernel(dev, tables, dtype):
    bg, tf, tau0, k, _, _ = tables
    po64 = tpert.evolve_perturbations(bg, tf, tau0, k)
    po = po64._replace(**{f: getattr(po64, f).to(dtype) for f in
                          ("tau", "k", "s0", "s1", "s2", "slens", "tau0")})
    args = dict(coarse_k=source_k_grid(0.1, 8, 16), lmax=400, kmax_hint=0.1,
                tau_stride=4)
    chi = (tau0 - 280.0).to(dtype)
    n0 = kernels.launches["los_rec"]
    clt_k = tcls.compute_cl_transfers_recurrence(po, chi, **args)
    again = tcls.compute_cl_transfers_recurrence(po, chi, **args)
    torch.cuda.synchronize()
    assert kernels.launches["los_rec"] == n0 + 2
    with _plain(tcls, "_los_rec_cuda"):
        clt_p = tcls.compute_cl_transfers_recurrence(po, chi, **args)
        po_r = po._replace(**{f: getattr(po, f).double() for f in
                              ("tau", "k", "s0", "s1", "s2", "slens", "tau0")})
        clt_r = tcls.compute_cl_transfers_recurrence(po_r, chi.double(), **args)
    for f in ("dT", "dE", "dP"):
        assert torch.equal(getattr(clt_k, f), getattr(again, f)), f
        check(getattr(clt_k, f), getattr(clt_p, f), getattr(clt_r, f), dtype,
              1e-4, f)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_tensor_kernels(dev, tables, dtype):
    """K5 on the 2048-step grid (16 tensor k), then K6 on K5's output."""
    bg, tf, tau0, _, _, _ = tables
    tfd = tf._replace(**{f: getattr(tf, f).to(dtype) for f in tf._fields})
    bgd = BackgroundParams(**{f: getattr(bg, f).to(dtype) for f in
                              ("ombh2", "omch2", "H0", "omk", "omnuh2", "nnu",
                               "w", "wa", "tcmb")},
                           num_massive_nu=bg.num_massive_nu)
    kt = tten.tensor_k_grid(nk=16)
    n0 = (kernels.launches["tensors"], kernels.launches["tensor_los"])
    to_k = tten.evolve_tensors(bgd, tfd, tau0.to(dtype), kt)
    tc_k = tten.compute_tensor_transfers(to_k, lmax=300)
    torch.cuda.synchronize()
    assert (kernels.launches["tensors"], kernels.launches["tensor_los"]) == \
        (n0[0] + 1, n0[1] + 1)
    with _plain(tten, "_evolve_t_cuda"):
        to_p = tten.evolve_tensors(bgd, tfd, tau0.to(dtype), kt)
        tf64 = tf._replace(**{f: getattr(tfd, f).double() for f in tf._fields})
        bg64 = BackgroundParams(**{f: getattr(bgd, f).double() for f in
                                   ("ombh2", "omch2", "H0", "omk", "omnuh2",
                                    "nnu", "w", "wa", "tcmb")},
                                num_massive_nu=bg.num_massive_nu)
        to_r = tten.evolve_tensors(bg64, tf64, tau0.to(dtype).double(), kt)
    for f in ("sT", "sP", "ht"):
        check(getattr(to_k, f), getattr(to_p, f), getattr(to_r, f), dtype,
              1e-4, f)
    with _plain(tten, "_tlos_cuda"):
        tc_p = tten.compute_tensor_transfers(to_k, lmax=300)
        to_kr = to_k._replace(**{f: getattr(to_k, f).double() for f in
                                 ("tau", "k", "sT", "sP", "tau0")})
        tc_r = tten.compute_tensor_transfers(to_kr, lmax=300)
    for f in ("dT", "dE", "dB"):
        check(getattr(tc_k, f), getattr(tc_p, f), getattr(tc_r, f), dtype,
              1e-4, f)


def _tlos_args(dev, dtype, chains, nkf, nt, ls, kmax, seed=0):
    """Arguments of _tlos_cuda / _tlos_plain, made from a seed: random
    sources on 10 coarse k, nkf fine k in [1e-3, kmax], tau0 - tau falling
    from 15000 to 0 (the chains' distances differ by up to 3%), the tables
    of `ls` from tlos_tables."""
    rng = np.random.default_rng(seed)
    coarse = np.exp(np.linspace(np.log(5e-4), np.log(1.5 * kmax), 10))
    kf = np.linspace(1e-3, kmax, nkf)
    chi = np.linspace(15000.0, 0.0, nt)[None] * np.linspace(1.0, 0.97, chains)[:, None]
    tabs = tten.tlos_tables(tuple(ls), kmax * 15000.0 * 1.02 + 10, dev)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    lo, hi, w = tten._k_stencil(torch.log(f(coarse)), torch.log(f(kf)))
    return (f(rng.standard_normal((chains, 2, len(coarse), nt))), lo, hi,
            w.contiguous(), f(kf), f(chi), f(rng.uniform(0.5, 1.5, (chains, nt))),
            tabs["jl"], tabs["jlp"], f(np.asarray(ls, np.float64)),
            float(torch.tensor(1.0 / tabs["dx"], dtype=dtype))), tabs


@pytest.mark.parametrize("case", ["ragged_k", "one_chain", "part_group", "dead_tiles",
                                  "none_dead"])
def test_tensor_los_kernel_layouts(dev, case):
    """K6 against _tlos_plain: 45 fine k (an item of 32 and a ragged one of
    13) and 46 l (two octet groups, the second part-filled); one chain; 12
    l (two octets of one group, the second part-filled); l = 300..500 at x
    below ~300 (whole tiles and items dead); l = 2..9 (no point dead)."""
    chains, nkf, nt, ls, kmax = {
        "ragged_k": (2, 45, 300, tcls.default_l_samples(300), 0.02),
        "one_chain": (1, 64, 200, tcls.default_l_samples(100), 0.03),
        "part_group": (3, 40, 250, [2, 3, 5, 8, 12, 20, 40, 80, 150, 250, 400, 700], 0.03),
        "dead_tiles": (2, 70, 400, [300, 350, 400, 450, 500], 0.02),
        "none_dead": (2, 33, 300, list(range(2, 10)), 0.02)}[case]
    for dtype in (F64, F32):
        args, tabs = _tlos_args(dev, dtype, chains, nkf, nt, ls, kmax)
        lat = tten.tlos_lattice(args[5], args[4], tabs["n0"], len(ls),
                                args[7].shape[1], args[10])
        if case == "dead_tiles":
            assert lat["live"] < lat["lattice"] // 4
        if case == "none_dead":
            assert lat["live"] == lat["lattice"]
        n0 = kernels.launches["tensor_los"]
        out_k = tten._tlos_cuda(*args)
        again = tten._tlos_cuda(*args)
        torch.cuda.synchronize()
        assert kernels.launches["tensor_los"] == n0 + 2
        assert torch.equal(out_k, again), "repeatable bit for bit"
        out_p = tten._tlos_plain(*args)
        out_r = None if dtype == F64 else tten._tlos_plain(
            *[a.double() if torch.is_tensor(a) and a.is_floating_point() else a
              for a in args])
        for p, name in enumerate(("dT", "dE", "dB")):
            check(out_k[p], out_p[p], None if out_r is None else out_r[p], dtype,
                  1e-4, (case, name))
    with pytest.raises(ValueError):
        tten._tlos_cuda(*args[:7], args[7].clone(), *args[8:])


def _rec_args(dev, dtype, chains, nkf, nt, lmax, k_lo, x_lo, x_hi, seed=0):
    """Arguments of _los_rec_cuda / _los_rec_plain, made from a seed: random
    sources on 12 coarse k in [k_lo, 1], stencils onto nkf fine k, and
    tau0 - tau falling along tau so that every x = kf (tau0 - tau) lies in
    [x_lo, x_hi] (the chains' distances differ by up to 3%)."""
    rng = np.random.default_rng(seed)
    coarse = np.exp(np.linspace(np.log(k_lo), 0.0, 12))
    kf = np.linspace(coarse[0], coarse[-1], nkf) if nkf > 1 else coarse[-1:]
    idx, w = tcls._cubic_k_weights(coarse, kf)
    chi = np.linspace(x_hi / kf[-1], x_lo / kf[0], nt)[None] \
        * np.linspace(1.0, 0.97, chains)[:, None]
    nu = np.arange(lmax + 1) + 0.5
    cut = np.maximum(nu - 2.5 * np.cbrt(nu), 0.0)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    return (f(rng.standard_normal((chains, 4, len(coarse), nt))),
            torch.as_tensor(idx, dtype=torch.int32, device=dev), f(w), f(kf), f(chi),
            f(rng.uniform(0.5, 1.5, (chains, nt))), f(rng.uniform(0.0, 1.0, (chains, nt))),
            torch.as_tensor(tcls.default_l_samples(lmax), dtype=torch.int32, device=dev),
            f(cut))


@pytest.mark.parametrize("case", ["nt_ragged", "no_warp_stops", "every_warp_stops",
                                  "one_k_one_chain"])
def test_los_rec_kernel_walks(dev, case):
    """K2b's warp walk against _los_rec_plain: 300 tau nodes (a warp of 44
    nodes and 20 pads, three warps of pads); x above cut[lmax] everywhere
    (no warp stops before lmax); x below cut[4] everywhere (every warp stops
    by l = 4); one fine k of one chain."""
    chains, nkf, nt, lmax, k_lo, x_lo, x_hi = {
        "nt_ragged": (2, 24, 300, 400, 1e-2, 0.0, 600.0),
        "no_warp_stops": (2, 16, 512, 60, 0.8, 80.0, 200.0),
        "every_warp_stops": (2, 16, 700, 300, 0.8, 0.0, 0.3),
        "one_k_one_chain": (1, 1, 2048, 500, 1e-2, 0.0, 900.0)}[case]
    for dtype in (F64, F32):
        args = _rec_args(dev, dtype, chains, nkf, nt, lmax, k_lo, x_lo, x_hi)
        n0 = kernels.launches["los_rec"]
        out_k = tcls._los_rec_cuda(*args, 0)
        again = tcls._los_rec_cuda(*args, 0)
        torch.cuda.synchronize()
        assert kernels.launches["los_rec"] == n0 + 2
        assert torch.equal(out_k, again), "repeatable bit for bit"
        out_p = tcls._los_rec_plain(*args, 64)
        out_r = None if dtype == F64 else tcls._los_rec_plain(
            *[a.double() if a.is_floating_point() else a for a in args], 64)
        for p, name in enumerate(("dT", "dE", "dP")):
            check(out_k[p], out_p[p], None if out_r is None else out_r[p], dtype,
                  1e-4, (case, name))


def _tensor_tables(tables, substeps):
    bg, tf, _, _, _, _ = tables
    return tten._stage_table(bg, tf, substeps)


@pytest.mark.parametrize("case", ["one_lane", "ragged_k", "substeps_2", "no_feedback",
                                  "rows_differ"])
def test_tensor_kernel_layouts(dev, tables, case):
    """K5's warp layout against _evolve_t_plain: one (chain, k) lane; 13 k
    (a last block of 5 warps); 2 substeps (7 rows a step); no anisotropic
    stress; step-start rows that differ from the step before's last row
    (no evaluation reused)."""
    substeps = 2 if case == "substeps_2" else 1
    q = _tensor_tables(tables, substeps)
    kt = torch.as_tensor(tten.tensor_k_grid(nk=16), dtype=F64, device=dev)
    fb = case != "no_feedback"
    if case == "one_lane":
        q, kt = q[:1], kt[-1:]
    elif case == "ragged_k":
        kt = kt[-13:]
    elif case == "rows_differ":
        q = q.clone()
        q[:, :, 0, tten.QT_OPAC] *= 1.0 + 1e-6
    assert case != "rows_differ" or not torch.equal(q[:, 1:, 0], q[:, :-1, -1])
    for dtype in (F64, F32):
        qd, kd = q.to(dtype).contiguous(), kt.to(dtype).contiguous()
        n0 = kernels.launches["tensors"]
        out_k = tten._evolve_t_cuda(qd, kd, substeps, fb)
        torch.cuda.synchronize()
        assert kernels.launches["tensors"] == n0 + 1
        out_p = tten._evolve_t_plain(qd, kd, substeps, fb)
        out_r = out_p if dtype == F64 else tten._evolve_t_plain(
            qd.double(), kd.double(), substeps, fb)
        for p, name in enumerate(tten.T_PLANES):
            check(out_k[p], out_p[p], out_r[p], dtype, 1e-4, (case, name))


def _lens_inputs(dev, lmax=800, chains=2):
    l = torch.arange(2, lmax + 1, dtype=F64, device=dev)
    damp = torch.exp(-(l / 1400.0) ** 2)
    tt = 5800.0 * damp * (0.35 + torch.cos(np.pi * l / 300.0) ** 2)
    ee = 40.0 * damp * (l / 1000.0) * (1.0 + torch.sin(np.pi * l / 300.0) ** 2)
    te = 0.4 * torch.sqrt(tt * ee) * torch.cos(np.pi * l / 150.0)
    pp = 1.8e-7 * (l / 40.0) / (1.0 + (l / 40.0) ** 2) ** 1.2
    amp = torch.linspace(1.0, 1.2, chains, dtype=F64, device=dev)[:, None]
    return l.to(torch.int64), [amp * x for x in (tt, te, ee, pp)]


@pytest.mark.parametrize("dtype,chains", [(F64, 2), (F32, 2), (F64, 9)])
def test_lensing_kernel(dev, dtype, chains):
    """lmax 800 -> 650: 1599 theta (not a multiple of the 128-theta
    block), 799 and 649 multipoles (not multiples of the 64-l segment);
    9 chains leave the second 8-chain register tile ragged."""
    ls, st64 = _lens_inputs(dev, chains=chains)
    st = [x.to(dtype) for x in st64]
    n0 = kernels.launches["lensing"]
    out_k = tlens.lens_cls(ls, *st, lmax_lensed=650)
    out_k2 = tlens.lens_cls(ls, *st, lmax_lensed=650)
    torch.cuda.synchronize()
    assert kernels.launches["lensing"] == n0 + 2
    with _plain(tlens, "_passes_cuda", "_passes_grid_plain"):
        out_p = tlens.lens_cls(ls, *st, lmax_lensed=650)
        out_r = tlens.lens_cls(ls, *[x.double() for x in st], lmax_lensed=650)
    for f in ("tt", "te", "ee", "bb"):
        assert torch.equal(getattr(out_k, f), getattr(out_k2, f)), f
        check(getattr(out_k, f), getattr(out_p, f), getattr(out_r, f), dtype,
              1e-4, f)


def test_lensing_kernel_theta_grid_options(dev):
    """The wrapper builds its theta nodes and recurrence seeds from
    (n_theta, apodize): an odd n_theta without the apodizing tail."""
    ls, st = _lens_inputs(dev)
    kw = dict(lmax_lensed=650, n_theta=1501, apodize=False)
    out_k = tlens.lens_cls(ls, *st, **kw)
    with _plain(tlens, "_passes_cuda", "_passes_grid_plain"):
        out_p = tlens.lens_cls(ls, *st, **kw)
    for f in ("tt", "te", "ee", "bb"):
        check(getattr(out_k, f), getattr(out_p, f), None, F64, 0.0, f)
    with pytest.raises(ValueError):
        tlens._passes_cuda(torch.zeros(2, 4, 799, dtype=F64, device=dev),
                           1600, True, 800)


def test_wrappers_reject_bad_inputs(dev):
    # a stage table without the massive-neutrino fields for that variant
    q = torch.zeros(1, 4, 3, tpert.NQ, dtype=F64, device=dev)
    k, rnu = torch.ones(2, dtype=F64, device=dev), torch.ones(1, dtype=F64, device=dev)
    with pytest.raises(ValueError):
        tpert._evolve_cuda(q, k, rnu, tpert.RSA_KTAU, massive_nu=True)
    with pytest.raises(ValueError):
        tpert._evolve_cuda(q, k, rnu, tpert.RSA_KTAU, iso=torch.zeros(1, 2, dtype=F64,
                                                                     device=dev))
    zt = torch.zeros(1, trec.N_ZT, 8, dtype=F64, device=dev)
    with pytest.raises(ValueError):
        trec._scan_cuda(zt[:, :, ::2], torch.zeros(1, dtype=F64, device=dev))
    with pytest.raises(ValueError):
        trec._scan_cuda(zt.half(), torch.zeros(1, dtype=torch.float16,
                                               device=dev))
