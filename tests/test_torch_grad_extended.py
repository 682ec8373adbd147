"""K1's reverse pass for the massive-neutrino and dark-energy instantiations
(CPU, float64).

(a) The hand-written adjoint of csrc/boltzmann_adjoint.cuh, built for the
host by the C++ compiler through csrc/boltzmann_adjoint_host.cpp and loaded
by ctypes: one RK4 step of `_evolve_plain` with the sources at its end, and
its vjp, for the four instantiations (base, nu, de, nu_de), on real stage
rows (the port's `_stage_tables` on JAX's thermal tables: 256 steps, kmax
0.1, two chains with mnu 0.3 and 0.1 eV, w0/wa (-0.9, -0.4) and (-1.1,
0.2), isocurvature b 0.2 and -0.1) and on the states the plain loop reaches
there, against torch.autograd of the plain version's step
(`perturbations._step`, which `_evolve_plain` takes). Lanes k = 0.002, 0.02, 0.1
and the radiation-streaming switch at k tau = 40 so that the steps picked
cross every switch: a held step (ICs), the release, tight coupling on and
off, RSA (which freezes the DE fluid), nu_rel_rsa by (am < 2) and by k
dt_loc > 0.9. Tolerance 1e-12 of each cotangent's largest component.
Skips only where no C++ compiler is found.

(b) The vjp of the port's evolve_perturbations with massive_nu, de_perts and
both (the isocurvature amplitude free and nonzero in the last), w.r.t. the
background parameters (ombh2, omch2, H0, mnu, w, wa, b) and the thermal
tables, against jax.vjp of JAX's evolve_perturbations on JAX's own tables,
as tests/test_torch_grad_perturbations.py does for the base layout: 8 k to
0.02/Mpc, rsa_ktau 40, z_outputs (0.05, 0.6), seeded cotangents on every
output; the port unchunked and with 4 remat chunks against JAX (whose
chunks change no number). Tolerance 1e-9 of each gradient's largest
component. Not z = 0: there the snapshot falls on the grid's last node,
and each package's own tau(a = 1) (the port's sits ulps below JAX's,
ROADMAP.md's inherited facts) lands on its own side of jnp.interp's clamp
for the mnu = 0.3 chain, so the snapshot's derivative in the parameters
differs by the last interval's slope (16% of the mnu chain's parameter
gradient), whatever K1 does.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import perturbations as jpert
from cosmomc_tpu.models.background import BackgroundParams as JBG
from cosmomc_tpu.params.parameterizations import mnu_to_omnuh2 as j_mnu

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models.background import BackgroundParams as TBG
from cosmomc_tpu_torch.params.parameterizations import mnu_to_omnuh2 as t_mnu

F64 = torch.float64
N_STEP = 256
KMAX_GRID = 0.1
RSA = 40.0
YHE, TAU = 0.2454, 0.0543
#: (ombh2, omch2, H0, mnu, w, wa, b) of each chain
PARAMS = np.array([[0.02237, 0.1201, 67.3, 0.3, -0.9, -0.4, 0.2],
                   [0.0221, 0.1230, 66.1, 0.1, -1.1, 0.2, -0.1]])
VARIANTS = {"base": (False, False), "nu": (True, False), "de": (False, True),
            "nu_de": (True, True)}
CSRC = os.path.join(os.path.dirname(os.path.abspath(tpert.__file__)), "..",
                    "csrc")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jbg(p):
    return JBG(ombh2=p[0], omch2=p[1], H0=p[2], omk=jnp.float64(0.0),
               omnuh2=j_mnu(p[3]), nnu=jnp.float64(3.046), w=p[4], wa=p[5],
               tcmb=jnp.float64(2.7255), num_massive_nu=1)


def _tbg(p):
    return TBG.make(ombh2=p[:, 0], omch2=p[:, 1], H0=p[:, 2],
                    omnuh2=t_mnu(p[:, 3]), w=p[:, 4], wa=p[:, 5],
                    tcmb=2.7255, nchains=p.shape[0], dtype=F64)


@pytest.fixture(scope="module")
def tables():
    """JAX's tau grid and thermal tables of each chain, and tau0."""
    tf, tau0 = jax.jit(jax.vmap(lambda p: jpert.build_thermo_funcs(
        _jbg(p), jnp.float64(YHE), jnp.float64(TAU), n_step=N_STEP,
        kmax=KMAX_GRID)))(jnp.asarray(PARAMS))
    return [np.asarray(t) for t in tf], np.asarray(tau0)


# ---- (a) the host-built adjoint against autograd of the plain step ---------

A_K = np.array([0.002, 0.02, 0.1])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++ or c++) on PATH to build "
                    "csrc/boltzmann_adjoint_host.cpp")
    out = str(tmp_path_factory.mktemp("k1adj") / "libk1adj.so")
    res = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-I",
                          CSRC, "-o", out,
                          os.path.join(CSRC, "boltzmann_adjoint_host.cpp")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return ctypes.CDLL(out)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _switches(q, k, nu):
    """Per (step, stage) row of one chain and lane: which switches hold."""
    tau, opac = q[..., tpert.Q_TAU], q[..., tpert.Q_OPAC]
    R, dtl = q[..., tpert.Q_R], q[..., tpert.Q_DTLOC]
    rsa = k * tau >= RSA
    tc_off = ((k / np.maximum(opac, 1e-30) >= tpert.TC_KTAUC)
              | (opac * tau <= tpert.TC_OPACTAU)) & (opac * (1 + R) * dtl <= 1.3)
    held = ~((k * tau >= tpert.IC_RELEASE_KTAU) | (tau >= 3.0))
    am_lt2 = q[..., tpert.Q_AMLT2] != 0 if nu else np.zeros_like(rsa)
    return dict(rsa=rsa, tc_on=~tc_off & ~rsa, held=held,
                nu_rel_am=rsa & am_lt2, nu_rel_dt=rsa & ~am_lt2 & (k * dtl > 0.9))


def _picks(q, nu):
    """(chain, lane, step, what) of steps that cross each switch."""
    want = ["held", "release", "tc_on", "tc_off", "tca_release", "rsa",
            "rsa_entry"] + (["nu_rel_am", "nu_rel_dt"] if nu else [])
    found = {}
    for c in range(q.shape[0]):
        for j, k in enumerate(A_K):
            s = _switches(q[c], k, nu)
            b, a = (lambda f: f[:, 2]), (lambda f: f[:, 0])
            cond = dict(
                held=b(s["held"]),
                release=a(s["held"]) & ~b(s["held"]),
                tc_on=~b(s["held"]) & a(s["tc_on"]) & b(s["tc_on"]),
                tc_off=~a(s["held"]) & ~s["tc_on"].any(1) & ~s["rsa"].any(1),
                tca_release=~a(s["held"]) & a(s["tc_on"]) & ~b(s["tc_on"]),
                rsa=a(s["rsa"]),
                rsa_entry=~a(s["rsa"]) & b(s["rsa"]),
                nu_rel_am=b(s["nu_rel_am"]) & ~a(s["held"]),
                nu_rel_dt=b(s["nu_rel_dt"]) & ~a(s["held"]))
            for what in want:
                idx = np.flatnonzero(cond[what])
                if what not in found and idx.size:
                    found[what] = (c, j, int(idx[idx.size // 2]))
    missing = [w for w in want if w not in found]
    assert not missing, f"no step crosses {missing}"
    return [(c, j, s, w) for w, (c, j, s) in found.items()]


@pytest.fixture(scope="module")
def lanes(tables):
    """Per variant: the stage table, the states before every step of each
    lane (the plain loop from the ICs), rnu and the isocurvature inputs."""
    tf, _ = tables
    bg = _tbg(torch.as_tensor(PARAMS))
    tft = tpert.ThermoFuncs(*[torch.tensor(t) for t in tf])
    k = torch.as_tensor(A_K)
    rnu = tpert._r_nu(bg)[:, None]
    iso = tpert.iso_inputs(bg, torch.as_tensor(PARAMS[:, 6]))
    out = {}
    for v, (nu, de) in VARIANTS.items():
        q = tpert._stage_tables(bg, tft, nu, de)
        y = tpert.adiabatic_ics(k, q[:, 0, 0, :1], rnu, nu, de, iso)
        ys = [y]
        with torch.no_grad():
            for s in range(q.shape[1] - 1):
                y = tpert._step(y, q[:, s, 0], q[:, s, 1], q[:, s, 2], k, rnu,
                                iso, RSA, nu, de)[0]
                ys.append(y)
        out[v] = (q, torch.stack(ys, 2), rnu, iso)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_host_adjoint_step_vjp(host_lib, lanes, variant):
    nu, de = VARIANTS[variant]
    q, ys, rnu, iso = lanes[variant]
    nuc = np.ascontiguousarray(np.stack([tpert._NU_WNORM, tpert._NU_DLNF]))
    rng = np.random.default_rng(1701)
    fwd = getattr(host_lib, f"k1_step_{variant}")
    vjp = getattr(host_lib, f"k1_step_vjp_{variant}")
    nv, nq = ys.shape[-1], q.shape[-1]
    for c, j, s, what in _picks(q.numpy(), nu):
        k = torch.as_tensor(A_K[j:j + 1])
        leaves = [ys[c:c + 1, j:j + 1, s].clone(), *(q[c:c + 1, s, i].clone()
                                                    for i in range(3)),
                  rnu[c:c + 1].clone(), iso[c:c + 1].clone()]
        for t in leaves:
            t.requires_grad_(True)
        y_new, planes = tpert._step(leaves[0], *leaves[1:4], k, leaves[4],
                                    leaves[5], RSA, nu, de)
        ynb = rng.standard_normal(nv)
        g = rng.standard_normal(7)
        loss = (y_new[0, 0] * torch.as_tensor(ynb)).sum() + (
            planes[:, 0, 0] * torch.as_tensor(g)).sum()
        ref = [x.detach().numpy().ravel() for x in torch.autograd.grad(loss, leaves)]

        arr = lambda t: np.ascontiguousarray(t.detach().numpy().ravel())
        y0, qa, qm, qb = (arr(t) for t in leaves[:4])
        isoa = arr(leaves[5])
        kk, r = float(A_K[j]), float(leaves[4].detach())
        yn, pl = np.zeros(nv), np.zeros(7)
        fwd.restype = None
        fwd(_ptr(y0), _ptr(qa), _ptr(qm), _ptr(qb), ctypes.c_double(kk),
            ctypes.c_double(RSA), ctypes.c_double(r), _ptr(isoa), _ptr(nuc),
            _ptr(yn), _ptr(pl))
        np.testing.assert_allclose(yn, y_new.detach().numpy().ravel(), rtol=1e-12,
                                   atol=1e-12 * np.abs(yn).max(), err_msg=what)
        np.testing.assert_allclose(pl, planes.detach().numpy().ravel(), rtol=1e-12,
                                   atol=1e-12 * np.abs(pl).max(), err_msg=what)
        yb, qab, qmb, qbb = np.zeros(nv), np.zeros(nq), np.zeros(nq), np.zeros(nq)
        rnu_b, isob = np.zeros(1), np.zeros(3)
        ynb, g = np.ascontiguousarray(ynb), np.ascontiguousarray(g)
        vjp.restype = None
        vjp(_ptr(y0), _ptr(qa), _ptr(qm), _ptr(qb), ctypes.c_double(kk),
            ctypes.c_double(RSA), ctypes.c_double(r), _ptr(isoa), _ptr(nuc),
            _ptr(ynb), _ptr(g), _ptr(yb), _ptr(qab), _ptr(qmb), _ptr(qbb),
            _ptr(rnu_b), _ptr(isob))
        for name, got, want in zip(("y", "qa", "qm", "qb", "rnu", "iso"),
                                   (yb, qab, qmb, qbb, rnu_b, isob), ref):
            scale = np.abs(want).max()
            err = np.abs(got - want).max() / scale if scale > 0 else np.abs(got).max()
            assert err <= 1e-12, (what, (c, j, s), name, err)


# ---- (b) the port's evolve_perturbations vjp against jax.vjp ---------------

B_K = np.geomspace(5e-4, 0.02, 8)
Z_OUT = (0.05, 0.6)
FIELDS = ("s0", "s1", "s2", "slens", "delta_m", "r_init", "delta_m_z",
          "ddelta_m_z", "weyl_z", "aH_z")
#: per case: (massive_nu, de_perts), whether b is free, the port's chunk
#: counts (chunking changes no number: test_torch_grad_perturbations.py's
#: test_chunks_change_no_number holds that bit for bit)
CASES = {"nu": ((True, False), False, (0,)),
         "de": ((False, True), False, (4,)),
         "nu_de": ((True, True), True, (4,))}
PNAMES = ("ombh2", "omch2", "H0", "mnu", "w", "wa", "b")


@pytest.fixture(scope="module")
def cotangents():
    rng = np.random.default_rng(1717)
    nk, nz = len(B_K), len(Z_OUT)
    shapes = dict(s0=(nk, N_STEP), s1=(nk, N_STEP), s2=(nk, N_STEP),
                  slens=(nk, N_STEP), delta_m=(nk,), r_init=(nk,),
                  delta_m_z=(nz, nk), ddelta_m_z=(nz, nk), weyl_z=(nz, nk),
                  aH_z=(nz,))
    return {f: rng.standard_normal((2,) + shapes[f]) for f in FIELDS}


def _jax_vjp(tf, tau0, cot, sw, iso):
    def one(p, tfa, t0, ct):
        def f(p, tfa):
            po = jpert.evolve_perturbations(
                _jbg(p), jpert.ThermoFuncs(*tfa), t0, jnp.asarray(B_K), Z_OUT,
                rsa_ktau=RSA, massive_nu=sw[0], de_perts=sw[1],
                iso_cdm_amp=p[6] if iso else 0.0)
            return [getattr(po, n) for n in FIELDS]
        out, vjp = jax.vjp(f, p, tfa)
        return out, vjp(ct)
    out, (gp, gtf) = jax.jit(jax.vmap(one))(
        jnp.asarray(PARAMS), tuple(jnp.asarray(t) for t in tf),
        jnp.asarray(tau0), [jnp.asarray(cot[f]) for f in FIELDS])
    return ([np.asarray(o) for o in out],
            [np.asarray(gp)] + [np.asarray(g) for g in gtf])


def _port_vjp(tf, tau0, cot, sw, iso, chunks):
    p = torch.tensor(PARAMS, dtype=F64, requires_grad=True)
    tfa = [torch.tensor(t, dtype=F64, requires_grad=True) for t in tf]
    po = tpert.evolve_perturbations(
        _tbg(p), tpert.ThermoFuncs(*tfa), torch.tensor(tau0, dtype=F64),
        torch.as_tensor(B_K, dtype=F64), Z_OUT, rsa_ktau=RSA,
        massive_nu=sw[0], de_perts=sw[1],
        iso_cdm_amp=p[:, 6] if iso else 0.0, remat_chunks=chunks)
    loss = sum((getattr(po, f) * torch.as_tensor(cot[f])).sum()
               for f in FIELDS)
    grads = torch.autograd.grad(loss, [p] + tfa, allow_unused=True)
    return ([getattr(po, f).detach().numpy() for f in FIELDS],
            [np.zeros(PARAMS.shape) if g is None else g.numpy()
             for g in grads])


@pytest.fixture(scope="module", params=list(CASES))
def case(request, tables, cotangents):
    sw, iso, chunks = CASES[request.param]
    tf, tau0 = tables
    ref = _jax_vjp(tf, tau0, cotangents, sw, iso)
    return request.param, ref, {c: _port_vjp(tf, tau0, cotangents, sw, iso, c)
                                for c in chunks}


def test_extended_vjp_matches_jax(case):
    name, (jout, jg), ports = case
    for chunks, (tout, tg) in ports.items():
        for f, j, t in zip(FIELDS, jout, tout):
            assert np.all(np.isfinite(t)), (name, f)
            np.testing.assert_allclose(t, j, rtol=1e-9,
                                       atol=1e-9 * np.abs(j).max(),
                                       err_msg=f"{name} {f}")
        for i, what in enumerate(["params"] + list(tpert.ThermoFuncs._fields)):
            for c in range(2):
                ref, got = jg[i][c], tg[i][c]
                assert np.all(np.isfinite(got))
                err = np.abs(got - ref).max() / np.abs(ref).max()
                assert err <= 1e-9, (name, chunks, what, c, err)
        # every parameter, mnu, w, wa (and b where free) among them, moves
        # the outputs
        nz = np.abs(tg[0]).min(0)
        assert np.all(nz[:6] > 0) and (nz[6] > 0) == CASES[name][1], (name, nz)
