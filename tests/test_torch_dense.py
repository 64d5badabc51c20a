"""The port's blocked all-pairs passes (``ops/dense.py``) against the JAX
package's, function by function, from the same particles (the JAX initial
conditions, handed over as numpy arrays).

Both are the same f32 expressions; only the order of the sums over j
differs (XLA's reduction against PyTorch's), so counts must be equal and
floats agree to rtol 1e-5, with an atol of 1e-5 of the field's largest
magnitude for the vector sums whose terms cancel (grad P, grad phi, the
div/curl sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu.ops import dense as jd
from planetmodel_sph_tpu.ops import eos as jeos
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import dense as td

KW = dict(n=200, radius=8.0, particle_radius=2.0, gravity_solver="direct",
          block_n=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's first multi-threaded CPU call in a process can round a few
    rows differently from every later call; one thread keeps the tight
    tolerances here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = {**KW, **kw}
    return jc.SimConfig(**kw), tc.SimConfig(**kw)


def _particles(jcfg, rotating=False):
    """(numpy dict, jax state) from the JAX ICs, with a density and
    pressure from the JAX pass 1 so pass 2 sees realistic fields."""
    st = jics.rotating_planet(jcfg, omega=0.3) if rotating \
        else jics.jupiter(jcfg)
    if rotating:
        # a contraction on top of the rotation, so pairs approach
        st = st.replace(vel=st.vel - 0.2 * st.pos)
    p1 = jd.pass1(st.pos, st.h, st.mass, jcfg)
    prs = jeos.pressure(p1.rho, jcfg.eos_k, jcfg.eos_gamma)
    st = st.replace(rho=p1.rho, pressure=prs)
    arr = {k: np.asarray(getattr(st, k))
           for k in ("pos", "vel", "h", "mass", "rho", "pressure")}
    return arr, st


def _t(arr, *names):
    return [torch.from_numpy(np.array(arr[k])) for k in names]


def _close(out, ref, rtol=1e-5, cancelling=False):
    ref = np.asarray(ref)
    atol = 1e-5 * np.abs(ref).max() if cancelling else 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("softening", ["receiver_h", "symmetric_max"])
@pytest.mark.parametrize("gravity", ["direct", "none"])
def test_pass1_matches_jax(softening, gravity):
    jcfg, tcfg = _cfgs(softening_mode=softening, gravity_solver=gravity)
    arr, st = _particles(jcfg)
    ref = jd.pass1(st.pos, st.h, st.mass, jcfg)
    out = td.pass1(*_t(arr, "pos", "h", "mass"), tcfg)
    _close(out.rho, ref.rho)
    np.testing.assert_array_equal(out.n_neighbors.numpy(),
                                  np.asarray(ref.n_neighbors))
    _close(out.phi, ref.phi)
    _close(out.grad_phi, ref.grad_phi, cancelling=True)
    np.testing.assert_array_equal(out.n_direct.numpy(),
                                  np.asarray(ref.n_direct))
    assert out.n_neighbors.dtype == torch.int32
    assert bool(out.n_direct.any()) == (gravity == "direct")


def test_pass1_gravity_only_matches_jax():
    jcfg, tcfg = _cfgs()
    arr, st = _particles(jcfg)
    ref = jd.pass1(st.pos, st.h, st.mass, jcfg, sph=False)
    out = td.pass1(*_t(arr, "pos", "h", "mass"), tcfg, sph=False)
    assert not out.rho.any() and not out.n_neighbors.any()
    _close(out.phi, ref.phi)
    _close(out.grad_phi, ref.grad_phi, cancelling=True)


def test_pass1_src_and_target_offset_match_jax():
    """Targets = rows 64..136 of the particle set, sources = all of it with
    two inert (mass 0) particles: the sharded-sources form."""
    jcfg, tcfg = _cfgs()
    arr, _ = _particles(jcfg)
    arr["mass"] = arr["mass"].copy()
    arr["mass"][[3, 100]] = 0.0
    sl = slice(64, 136)
    jsrc = tuple(jnp.asarray(arr[k]) for k in ("pos", "h", "mass"))
    ref = jd.pass1(*(a[sl] for a in jsrc), jcfg, src=jsrc, target_offset=64)
    tsrc = tuple(_t(arr, "pos", "h", "mass"))
    out = td.pass1(*(a[sl] for a in tsrc), tcfg, src=tsrc, target_offset=64)
    _close(out.rho, ref.rho)
    np.testing.assert_array_equal(out.n_neighbors.numpy(),
                                  np.asarray(ref.n_neighbors))
    np.testing.assert_array_equal(out.n_direct.numpy(),
                                  np.asarray(ref.n_direct))
    _close(out.grad_phi, ref.grad_phi, cancelling=True)
    assert int(out.n_direct[0]) == 200 - 1 - 2


@pytest.mark.parametrize("mode", ["reference_asymmetric", "symmetric"])
@pytest.mark.parametrize("bug", [False, True])
def test_pass2_matches_jax(mode, bug):
    jcfg, tcfg = _cfgs(grad_p_mode=mode, kernel_deriv_sign_bug=bug)
    arr, st = _particles(jcfg)
    ref = jd.pass2(st.pos, st.h, st.mass, st.rho, st.pressure, jcfg)
    out = td.pass2(*_t(arr, "pos", "h", "mass", "rho", "pressure"), tcfg)
    _close(out, ref, cancelling=True)


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("balsara", [False, True])
def test_pass2_viscosity_matches_jax(balsara, bug):
    jcfg, tcfg = _cfgs(av_alpha=1.0, av_beta=2.0, av_balsara=balsara,
                       kernel_deriv_sign_bug=bug)
    arr, st = _particles(jcfg, rotating=True)
    fb = np.linspace(0.2, 1.0, jcfg.n).astype(np.float32)
    kw_j = dict(fbal=jnp.asarray(fb)) if balsara else {}
    kw_t = dict(fbal=torch.from_numpy(fb)) if balsara else {}
    ref = jd.pass2(st.pos, st.h, st.mass, st.rho, st.pressure, jcfg,
                   vel=st.vel, **kw_j)
    out = td.pass2(*_t(arr, "pos", "h", "mass", "rho", "pressure"), tcfg,
                   vel=_t(arr, "vel")[0], **kw_t)
    if balsara:
        _close(out[0], ref[0], cancelling=True)
        _close(out[1], ref[1], cancelling=True)
        assert out[1].shape == (jcfg.n, 4)
    else:
        _close(out, ref, cancelling=True)
    # the viscosity is not a no-op on this velocity field
    plain = td.pass2(*_t(arr, "pos", "h", "mass", "rho", "pressure"),
                     tcfg.replace(av_alpha=0.0))
    gp = out[0] if balsara else out
    assert not torch.allclose(gp, plain, rtol=1e-3)


@pytest.mark.parametrize("balsara", [False, True])
def test_viscosity_accel_matches_jax(balsara):
    jcfg, tcfg = _cfgs(av_alpha=1.0, av_beta=2.0, av_balsara=balsara)
    arr, st = _particles(jcfg, rotating=True)
    ref = jd.viscosity_accel(st.pos, st.vel, st.h, st.mass, st.rho, jcfg)
    out = td.viscosity_accel(*_t(arr, "pos", "vel", "h", "mass", "rho"),
                             tcfg)
    if balsara:
        _close(out[0], ref[0], cancelling=True)
        _close(out[1], ref[1], cancelling=True)
    else:
        _close(out, ref, cancelling=True)


def test_gradh_density_and_force_match_jax():
    jcfg, tcfg = _cfgs(grad_p_mode="grad_h")
    arr, st = _particles(jcfg)
    rho, omega, nn = jd.density_gradh(st.pos, st.h, st.mass, jcfg)
    t_rho, t_omega, t_nn = td.density_gradh(*_t(arr, "pos", "h", "mass"),
                                            tcfg)
    _close(t_rho, rho)
    _close(t_omega, omega)
    np.testing.assert_array_equal(t_nn.numpy(), np.asarray(nn))
    prs = jeos.pressure(rho, jcfg.eos_k, jcfg.eos_gamma)
    ref = jd.pass2_gradh(st.pos, st.h, st.mass, rho, omega, prs, jcfg)
    out = td.pass2_gradh(*_t(arr, "pos", "h", "mass"),
                         torch.from_numpy(np.array(rho)),
                         torch.from_numpy(np.array(omega)),
                         torch.from_numpy(np.array(prs)), tcfg)
    _close(out, ref, cancelling=True)


def test_balsara_factor_matches_jax():
    rng = np.random.default_rng(1)
    dc = rng.normal(size=(50, 4)).astype(np.float32)
    cs, rho, h = (rng.uniform(0.5, 2.0, 50).astype(np.float32)
                  for _ in range(3))
    ref = jd.balsara_factor(*(jnp.asarray(x) for x in (dc, cs, rho, h)))
    out = td.balsara_factor(*(torch.from_numpy(x) for x in (dc, cs, rho, h)))
    _close(out, ref)


@pytest.mark.parametrize("kw,word", [
    (dict(energy=True), "energy"), (dict(u=torch.zeros(4)), "u"),
    (dict(matid=torch.zeros(4)), "matid")])
def test_unported_inputs_refused_by_name(kw, word):
    """The energy inputs are ported; what the dense passes still refuse,
    as the reference does: the energy equation without velocities or under
    the asymmetric form, and an evolved-u EOS whose viscosity is given no
    u (with or without material ids)."""
    z = torch.zeros(4)
    args = (torch.zeros(4, 3), z + 1, z + 1, z + 1, z)
    if word == "energy":
        _, tcfg = _cfgs(n=4)
        with pytest.raises(ValueError, match="needs velocities"):
            td.pass2(*args, tcfg, **kw)
        _, asym = _cfgs(n=4, grad_p_mode="reference_asymmetric")
        with pytest.raises(ValueError, match="momentum-conserving"):
            td.pass2(*args, asym, vel=torch.zeros(4, 3), **kw)
        with pytest.raises(ValueError, match="needs velocities"):
            td.pass2_gradh(*args[:4], z + 1, z, tcfg, **kw)
        return
    mode = "adiabatic" if word == "u" else "tillotson"
    _, tcfg = _cfgs(n=4, eos_mode=mode, av_alpha=1.0, av_beta=2.0)
    kw = dict(kw, u=None) if word == "matid" else dict(u=None)
    with pytest.raises(ValueError, match="needs the internal energy u"):
        td.pass2(*args, tcfg, vel=torch.zeros(4, 3), **kw)
    with pytest.raises(ValueError, match="needs the internal energy u"):
        td.viscosity_accel(args[0], torch.zeros(4, 3), *args[1:4], tcfg,
                           **kw)


# ---------------------------------------------------------------------------
# the energy columns
# ---------------------------------------------------------------------------

def _thermal(arr, jcfg, seed=3):
    """u (some exactly 0, one slightly negative) and mixed material ids."""
    rng = np.random.default_rng(seed)
    n = len(arr["h"])
    hi = 3e11 if jcfg.eos_mode == "tillotson" else 5.0
    u = rng.uniform(0.0, hi, n).astype(np.float32)
    u[::17] = 0.0
    u[5] = -1e-3 * hi
    return u, rng.integers(0, 5, n).astype(np.int32)


ENERGY_CASES = {
    "adiabatic": dict(eos_mode="adiabatic"),
    "adiabatic+av": dict(eos_mode="adiabatic", av_alpha=1.0, av_beta=2.0),
    "adiabatic+av+balsara+sign_bug": dict(
        eos_mode="adiabatic", av_alpha=1.0, av_beta=2.0, av_balsara=True,
        kernel_deriv_sign_bug=True),
    "tillotson+av+matid": dict(eos_mode="tillotson", av_alpha=1.0,
                               av_beta=2.0),
    "tillotson+av+balsara": dict(eos_mode="tillotson", material="iron",
                                 av_alpha=1.0, av_beta=2.0,
                                 av_balsara=True),
}


@pytest.mark.parametrize("case", sorted(ENERGY_CASES))
def test_pass2_energy_matches_jax(case):
    """pass2(energy=True): (grad_p, du_dt[, dc]); u and matid feed the
    viscosity's sound speed."""
    jcfg, tcfg = _cfgs(**ENERGY_CASES[case])
    arr, st = _particles(jcfg, rotating=True)
    u, mid = _thermal(arr, jcfg)
    with_mid = case.endswith("matid")
    jkw = dict(u=jnp.asarray(u))
    tkw = dict(u=torch.from_numpy(u))
    if with_mid:
        jkw["matid"], tkw["matid"] = jnp.asarray(mid), torch.from_numpy(mid)
    if jcfg.av_balsara:
        fb = np.random.default_rng(4).uniform(0, 1, len(u)).astype(
            np.float32)
        jkw["fbal"], tkw["fbal"] = jnp.asarray(fb), torch.from_numpy(fb)
    prs = jeos.pressure_cfg(st.rho, jcfg, u=jkw["u"], matid=jkw.get("matid"))
    ref = jd.pass2(st.pos, st.h, st.mass, st.rho, prs, jcfg, vel=st.vel,
                   energy=True, **jkw)
    out = td.pass2(*_t(arr, "pos", "h", "mass", "rho"),
                   torch.from_numpy(np.array(prs)), tcfg,
                   vel=_t(arr, "vel")[0], energy=True, **tkw)
    assert len(out) == len(ref) == (3 if jcfg.av_balsara else 2)
    for o, r in zip(out, ref):
        _close(o, r, cancelling=True)
    assert float(out[1].abs().max()) > 0.0 and out[1].shape == (jcfg.n,)
    # without energy the gradient is the same and du is not returned
    plain = td.pass2(*_t(arr, "pos", "h", "mass", "rho"),
                     torch.from_numpy(np.array(prs)), tcfg,
                     vel=_t(arr, "vel")[0], **tkw)
    gp = plain[0] if isinstance(plain, tuple) else plain
    assert torch.equal(gp, out[0])


def test_pass2_energy_src_and_target_offset_match_jax():
    jcfg, tcfg = _cfgs(eos_mode="adiabatic", av_alpha=1.0, av_beta=2.0)
    arr, st = _particles(jcfg, rotating=True)
    u, _ = _thermal(arr, jcfg)
    arr["u"] = u
    arr["pressure"] = np.asarray(jeos.pressure_cfg(st.rho, jcfg,
                                                   u=jnp.asarray(u)))
    sl = slice(64, 136)
    names = ("pos", "h", "mass", "rho", "pressure", "vel")
    jsrc = tuple(jnp.asarray(arr[k]) for k in names)
    ref = jd.pass2(*(a[sl] for a in jsrc[:5]), jcfg, src=jsrc,
                   target_offset=64, vel=jsrc[5][sl], energy=True,
                   u=jnp.asarray(u)[sl], u_src=jnp.asarray(u))
    tsrc = tuple(_t(arr, *names))
    tu = torch.from_numpy(u)
    out = td.pass2(*(a[sl] for a in tsrc[:5]), tcfg, src=tsrc,
                   target_offset=64, vel=tsrc[5][sl], energy=True,
                   u=tu[sl], u_src=tu)
    _close(out[0], ref[0], cancelling=True)
    _close(out[1], ref[1], cancelling=True)


@pytest.mark.parametrize("bug", [False, True])
def test_pass2_gradh_energy_matches_jax(bug):
    jcfg, tcfg = _cfgs(grad_p_mode="grad_h", eos_mode="adiabatic",
                       kernel_deriv_sign_bug=bug)
    arr, st = _particles(jcfg, rotating=True)
    u, _ = _thermal(arr, jcfg)
    rho, omega, _ = jd.density_gradh(st.pos, st.h, st.mass, jcfg)
    prs = jeos.pressure_cfg(rho, jcfg, u=jnp.asarray(u))
    ref = jd.pass2_gradh(st.pos, st.h, st.mass, rho, omega, prs, jcfg,
                         energy=True, vel=st.vel)
    T = lambda a: torch.from_numpy(np.array(a))
    out = td.pass2_gradh(*_t(arr, "pos", "h", "mass"), T(rho), T(omega),
                         T(prs), tcfg, energy=True, vel=_t(arr, "vel")[0])
    assert len(out) == 2
    _close(out[0], ref[0], cancelling=True)
    _close(out[1], ref[1], cancelling=True)
    assert float(out[1].abs().max()) > 0.0


@pytest.mark.parametrize("case", ["adiabatic+av",
                                  "adiabatic+av+balsara+sign_bug",
                                  "tillotson+av+matid"])
def test_viscosity_accel_energy_matches_jax(case):
    """(accel, du_dt[, dc]): the shock heating of the standalone sweep."""
    jcfg, tcfg = _cfgs(**ENERGY_CASES[case])
    arr, st = _particles(jcfg, rotating=True)
    u, mid = _thermal(arr, jcfg)
    jkw, tkw = dict(u=jnp.asarray(u)), dict(u=torch.from_numpy(u))
    if case.endswith("matid"):
        jkw["matid"], tkw["matid"] = jnp.asarray(mid), torch.from_numpy(mid)
    ref = jd.viscosity_accel(st.pos, st.vel, st.h, st.mass, st.rho, jcfg,
                             energy=True, **jkw)
    out = td.viscosity_accel(*_t(arr, "pos", "vel", "h", "mass", "rho"),
                             tcfg, energy=True, **tkw)
    assert len(out) == len(ref) == (3 if jcfg.av_balsara else 2)
    for o, r in zip(out, ref):
        _close(o, r, cancelling=True)
    # viscous heating only heats
    assert float(out[1].min()) >= 0.0 and float(out[1].max()) > 0.0
