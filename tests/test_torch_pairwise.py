"""The all-pairs kernels' plain versions (``ops/cuda/pairwise.py``) against
the Pallas kernels they replace, run in interpret mode as
``tests/test_pallas.py`` runs them, and against the port's ``ops/dense.py``.

Plain version against Pallas: the same f32 expressions (q = sqrt(r2)/h as a
multiply by 1/h, one rsqrt, min of the 1/h), so the counts must be EQUAL;
rho rtol 1e-5, phi 1e-4, the vector sums rtol 1e-3 with atol 1e-5 (the
bounds the JAX suite holds its Pallas kernels to against its dense path).
Plain version against ``ops/dense.py``: the same tolerances; their counts
are formed differently (r*(1/h) against r/h) and could differ by one at a
knife edge, which these seeded inputs do not hit, so equality is asserted
here too. On CPU tensors the wrappers run the plain versions and count no
launch; the CUDA kernels themselves are held to the plain versions on the
card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu.ops import dense as jd
from planetmodel_sph_tpu.ops import eos as jeos
from planetmodel_sph_tpu.ops.pallas import pairwise as jpw
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import dense as td
from planetmodel_sph_tpu_torch.ops.cuda import pairwise as tpw

KW = dict(radius=8.0, particle_radius=2.0, gravity_solver="direct",
          block_n=256)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's first multi-threaded CPU call in a process can round a few
    rows differently from every later call; one thread keeps the tight
    tolerances here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(n=200, **kw):
    kw = {**KW, "n": n, **kw}
    return jc.SimConfig(**kw), tc.SimConfig(**kw)


def _particles(jcfg, moving=False):
    st = jics.rotating_planet(jcfg, omega=0.3) if moving \
        else jics.jupiter(jcfg)
    if moving:
        # rotation plus contraction plus seeded noise: approaching and
        # receding pairs, non-zero divergence and curl
        rng = np.random.default_rng(11)
        noise = rng.normal(scale=0.3, size=(jcfg.n, 3)).astype(np.float32)
        st = st.replace(vel=st.vel - 0.2 * st.pos + jnp.asarray(noise))
    p1 = jd.pass1(st.pos, st.h, st.mass, jcfg)
    st = st.replace(rho=p1.rho, pressure=jeos.pressure(
        p1.rho, jcfg.eos_k, jcfg.eos_gamma))
    names = ("pos", "vel", "h", "mass", "rho", "pressure")
    return {k: torch.from_numpy(np.array(getattr(st, k))) for k in names}, st


def _close(out, ref, rtol, atol=0.0):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _hold_pass1(out, ref):
    _close(out.rho, ref.rho, 1e-5)
    np.testing.assert_array_equal(out.n_neighbors.numpy(),
                                  np.asarray(ref.n_neighbors))
    _close(out.phi, ref.phi, 1e-4)
    _close(out.grad_phi, ref.grad_phi, 1e-3, 1e-5)
    np.testing.assert_array_equal(out.n_direct.numpy(),
                                  np.asarray(ref.n_direct))


@pytest.mark.parametrize("n", [200, 137])
@pytest.mark.parametrize("softening", ["receiver_h", "symmetric_max"])
def test_pass1_plain_matches_pallas(softening, n):
    jcfg, tcfg = _cfgs(n, softening_mode=softening)
    t, st = _particles(jcfg)
    ref = jpw.pass1(st.pos, st.h, st.mass, jcfg)
    out = tpw.pass1_plain(t["pos"], t["h"], t["mass"], tcfg, block=64)
    _hold_pass1(out, ref)
    assert out.n_neighbors.dtype == out.n_direct.dtype == torch.int32
    assert int(out.n_direct[0]) == n - 1


def test_pass1_plain_no_gravity_matches_pallas():
    jcfg, tcfg = _cfgs(gravity_solver="none")
    t, st = _particles(jcfg)
    ref = jpw.pass1(st.pos, st.h, st.mass, jcfg)
    out = tpw.pass1_plain(t["pos"], t["h"], t["mass"], tcfg)
    assert not out.phi.any() and not out.grad_phi.any()
    assert not out.n_direct.any()
    _hold_pass1(out, ref)


@pytest.mark.parametrize("softening", ["receiver_h", "symmetric_max"])
def test_pass1_plain_matches_port_dense(softening):
    _, tcfg = _cfgs(softening_mode=softening)
    t, _ = _particles(_cfgs()[0])
    ref = td.pass1(t["pos"], t["h"], t["mass"], tcfg)
    out = tpw.pass1_plain(t["pos"], t["h"], t["mass"], tcfg)
    _hold_pass1(out, ref)


@pytest.mark.parametrize("n", [200, 137])
@pytest.mark.parametrize("mode", ["reference_asymmetric", "symmetric"])
@pytest.mark.parametrize("bug", [False, True])
def test_pass2_plain_matches_pallas(mode, bug, n):
    jcfg, tcfg = _cfgs(n, grad_p_mode=mode, kernel_deriv_sign_bug=bug)
    t, st = _particles(jcfg)
    ref = jpw.pass2(st.pos, st.h, st.mass, st.rho, st.pressure, jcfg)
    args = [t[k] for k in ("pos", "h", "mass", "rho", "pressure")]
    out = tpw.pass2_plain(*args, tcfg, block=64)
    _close(out, ref, 1e-3, 1e-5)
    _close(out, td.pass2(*args, tcfg), 1e-3, 1e-5)


@pytest.mark.parametrize("bug", [False, True])
@pytest.mark.parametrize("balsara", [False, True])
def test_pass2_plain_viscosity_matches_pallas(balsara, bug):
    jcfg, tcfg = _cfgs(av_alpha=1.0, av_beta=2.0, av_balsara=balsara,
                       kernel_deriv_sign_bug=bug)
    t, st = _particles(jcfg, moving=True)
    fb = np.linspace(0.2, 1.0, jcfg.n).astype(np.float32)
    kw_j = dict(fbal=jnp.asarray(fb)) if balsara else {}
    kw_t = dict(fbal=torch.from_numpy(fb)) if balsara else {}
    ref = jpw.pass2(st.pos, st.h, st.mass, st.rho, st.pressure, jcfg,
                    vel=st.vel, **kw_j)
    args = [t[k] for k in ("pos", "h", "mass", "rho", "pressure")]
    out = tpw.pass2_plain(*args, tcfg, vel=t["vel"], **kw_t)
    dense = td.pass2(*args, tcfg, vel=t["vel"], **kw_t)
    if balsara:
        assert out[1].shape == (jcfg.n, 4)
        for o, r, d in zip(out, ref, dense):
            _close(o, r, 1e-3, 1e-5)
            _close(o, d, 1e-3, 1e-5)
    else:
        _close(out, ref, 1e-3, 1e-5)
        _close(out, dense, 1e-3, 1e-5)
    # the viscosity moved the result: the agreement is not vacuous
    gp = out[0] if balsara else out
    assert not torch.allclose(
        gp, tpw.pass2_plain(*args, tcfg.replace(av_alpha=0.0)), rtol=1e-3)


def test_balsara_default_factor_is_one():
    _, tcfg = _cfgs(av_alpha=1.0, av_beta=2.0, av_balsara=True)
    t, _ = _particles(_cfgs()[0], moving=True)
    args = [t[k] for k in ("pos", "h", "mass", "rho", "pressure")]
    a = tpw.pass2_plain(*args, tcfg, vel=t["vel"])
    b = tpw.pass2_plain(*args, tcfg, vel=t["vel"],
                        fbal=torch.ones_like(t["rho"]))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_coincident_particles_and_guards_stay_finite():
    """Two particles at one point (r = 0 off the diagonal), an h <= 0 and
    a rho <= 0: the wrappers' guards and the r = 0 branch keep every output
    finite, as the Pallas kernels' do."""
    jcfg, tcfg = _cfgs(137, av_alpha=1.0, av_beta=2.0)
    t, st = _particles(jcfg, moving=True)
    t["pos"][5] = t["pos"][9]
    t["h"][7] = 0.0
    t["rho"][3] = 0.0
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    ref1 = jpw.pass1(j["pos"], j["h"], j["mass"], jcfg)
    out1 = tpw.pass1(t["pos"], t["h"], t["mass"], tcfg)
    _hold_pass1(out1, ref1)
    ref2 = jpw.pass2(j["pos"], j["h"], j["mass"], j["rho"], j["pressure"],
                     jcfg, vel=j["vel"])
    out2 = tpw.pass2(t["pos"], t["h"], t["mass"], t["rho"], t["pressure"],
                     tcfg, vel=t["vel"])
    assert torch.isfinite(out2).all() and torch.isfinite(out1.grad_phi).all()
    _close(out2, ref2, 1e-3, 1e-5)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    _, tcfg = _cfgs()
    t, _ = _particles(_cfgs()[0])
    tpw.reset_launches()
    out = tpw.pass1(t["pos"], t["h"], t["mass"], tcfg)
    ref = tpw.pass1_plain(t["pos"], t["h"], t["mass"], tcfg)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    gp = tpw.pass2(t["pos"], t["h"], t["mass"], t["rho"], t["pressure"],
                   tcfg)
    assert torch.equal(gp, tpw.pass2_plain(
        t["pos"], t["h"], t["mass"], t["rho"], t["pressure"], tcfg))
    assert all(v == 0 for v in tpw.LAUNCHES.values())
    assert set(tpw.KERNELS) <= set(tpw.LAUNCHES)


@pytest.mark.parametrize("bad,err", [
    (dict(pos=torch.zeros(200, 3, dtype=torch.float64)), TypeError),
    (dict(h=torch.ones(199)), ValueError),
    (dict(pos=torch.zeros(3, 200).t()), ValueError),      # not contiguous
    (dict(pos=torch.zeros(200, 2)), ValueError),
])
def test_wrappers_check_their_arguments(bad, err):
    _, tcfg = _cfgs()
    args = dict(pos=torch.zeros(200, 3), h=torch.ones(200),
                mass=torch.ones(200))
    args.update(bad)
    with pytest.raises(err, match="pairwise_pass1"):
        tpw.pass1(args["pos"], args["h"], args["mass"], tcfg)
    with pytest.raises(err, match="pairwise_pass2"):
        tpw.pass2(args["pos"], args["h"], args["mass"], torch.ones(200),
                  torch.ones(200), tcfg)


def test_pass2_refuses_grad_h_mode():
    _, tcfg = _cfgs(grad_p_mode="grad_h")
    with pytest.raises(ValueError, match="grad_p_mode"):
        tpw.pass2(torch.zeros(4, 3), torch.ones(4), torch.ones(4),
                  torch.ones(4), torch.ones(4), tcfg)


def test_splits_fill_the_card_and_stay_bounded():
    assert tpw.splits_for(3000) * -(-3000 // 128) >= 1056
    assert tpw.splits_for(32768) * 256 >= 1056
    assert tpw.splits_for(1) == 64 and tpw.splits_for(10 ** 6) == 1


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """The CUDA kernels against their plain versions (needs a CUDA card
    and nvcc; `python3 chip_smoke.py` runs the same comparison at full
    size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, tcfg = _cfgs(av_alpha=1.0, av_beta=2.0, av_balsara=True)
    t, _ = _particles(_cfgs()[0], moving=True)
    g = {k: v.cuda() for k, v in t.items()}
    out = tpw.pass1(g["pos"], g["h"], g["mass"], tcfg)
    ref = tpw.pass1_plain(g["pos"], g["h"], g["mass"], tcfg)
    assert torch.equal(out.n_neighbors, ref.n_neighbors)
    torch.testing.assert_close(out.rho, ref.rho, rtol=1e-4, atol=0)
    gp, dc = tpw.pass2(g["pos"], g["h"], g["mass"], g["rho"], g["pressure"],
                       tcfg, vel=g["vel"])
    gp_ref, dc_ref = tpw.pass2_plain(g["pos"], g["h"], g["mass"], g["rho"],
                                     g["pressure"], tcfg, vel=g["vel"])
    for o, r in ((gp, gp_ref), (dc, dc_ref)):
        torch.testing.assert_close(o, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
