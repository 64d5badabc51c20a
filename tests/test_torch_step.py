"""The dense slice as a whole: the port's uncached step (prime, step,
run_info, run_with_diagnostics) against the JAX package's from the same
arrays (the JAX initial conditions, handed over as numpy).

On the CPU the JAX package runs its ``ops/dense.py``; the port, with
`use_pallas` (the default), runs the plain versions of its all-pairs
kernels, and ``ops/dense.py`` with `use_pallas=False`: both are held to the
JAX run. Relax-mode h feeds on the neighbour counts, so a count that
differs by one moves h and the runs part chaotically: the counts are held
EQUAL after the first step and the fields over 8 steps only, pos, vel and
rho to rtol 1e-4, atol 1e-5 (f32 sums in different orders, 8 steps of
growth)."""

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu.models import planet as jp
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.models import planet as tp
from planetmodel_sph_tpu_torch.ops.cuda import pairwise as tpw

STEPS = 8
BASE = dict(n=512, radius=20.0, particle_radius=4.0)
CASES = {
    "kdk": {},
    "kdk_dense_module": dict(use_pallas=False),
    "staggered": dict(integrator="staggered_euler"),
    "cfl": dict(dt_mode="cfl", dt=0.05),
    "parity_flags": dict(grad_p_mode="reference_asymmetric",
                         kernel_deriv_sign_bug=True,
                         softening_mode="receiver_h",
                         integrator="staggered_euler"),
    "av_balsara": dict(av_alpha=1.0, av_beta=2.0, av_balsara=True),
    "no_gravity_damped": dict(gravity_solver="none", vel_damping=0.5),
    "gradh_newton": dict(grad_p_mode="grad_h", h_mode="newton",
                         av_alpha=1.0, av_beta=2.0),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's first multi-threaded CPU call in a process can round a few
    rows differently from every later call; one thread keeps the exact
    count comparison deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(jcfg, moving):
    st = jics.rotating_planet(jcfg, omega=0.05) if moving \
        else jics.jupiter(jcfg)
    if moving:
        st = st.replace(vel=st.vel - 0.02 * st.pos)
    return st, {k: np.asarray(v) for k, v in vars(st).items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    kw = {**BASE, **CASES[request.param]}
    jcfg, tcfg = jc.jupiter_3k(**kw), tc.jupiter_3k(**kw)
    st0, arrays = _start(jcfg, moving=kw.get("av_alpha", 0.0) > 0.0)
    ref0 = jax.jit(lambda s: jp.prime(s, jcfg))(st0)
    ref1, _ = jp.run_info(ref0, jcfg, 1)
    ref8, info_ref = jp.run_info(ref1, jcfg, STEPS - 1)
    tpw.reset_launches()
    out0 = tp.prime(tstate.from_numpy(arrays, device="cpu"), tcfg)
    out1, _ = tp.run_info(out0, tcfg, 1)
    out8, info = tp.run_info(out1, tcfg, STEPS - 1)
    return dict(ref=(ref0, ref1, ref8), out=(out0, out1, out8),
                info=(info_ref, info), cfg=(jcfg, tcfg))


def _close(a, b, name):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                               atol=1e-5, err_msg=name)


def test_prime_matches_jax(runs):
    ref, out = runs["ref"][0], runs["out"][0]
    for k in ("rho", "pressure", "phi", "accel", "grad_p", "grad_phi", "h"):
        _close(getattr(out, k), getattr(ref, k), k)
    for k in ("n_neighbors", "n_direct", "n_approx"):
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)


def test_counts_equal_after_the_first_step(runs):
    ref, out = runs["ref"][1], runs["out"][1]
    np.testing.assert_array_equal(out.n_neighbors.numpy(),
                                  np.asarray(ref.n_neighbors))
    _close(out.h, ref.h, "h")


def test_eight_steps_match_jax(runs):
    ref, out = runs["ref"][2], runs["out"][2]
    for k in ("pos", "vel", "rho", "h", "balsara"):
        _close(getattr(out, k), getattr(ref, k), k)
    for k in vars(out):
        assert getattr(out, k).shape == tuple(np.shape(getattr(ref, k))), k
    info_ref, info = runs["info"]
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_ref.items()} == \
        {"nbr_overflow": 0, "tree_overflow": 0}
    # the run moved the particles, so the agreement is not vacuous
    assert not np.allclose(out.pos.numpy(), runs["out"][0].pos.numpy())
    assert all(v == 0 for v in tpw.LAUNCHES.values())      # CPU: no launch


def test_run_with_diagnostics_matches_jax():
    kw = dict(BASE, n=256)
    jcfg, tcfg = jc.jupiter_3k(**kw), tc.jupiter_3k(**kw)
    st0, arrays = _start(jcfg, moving=False)
    ref, d_ref = jp.run_with_diagnostics(
        jax.jit(lambda s: jp.prime(s, jcfg))(st0), jcfg, 3, 2)
    out, d_out = tp.run_with_diagnostics(
        tp.prime(tstate.from_numpy(arrays, device="cpu"), tcfg), tcfg, 3, 2)
    assert set(d_out) == set(d_ref)
    for k, v in d_out.items():
        assert tuple(v.shape) == tuple(d_ref[k].shape) == (3,), k
    for k in ("total_energy", "kinetic_energy", "neighbors_avg", "rho_max",
              "radius_rms", "h_avg"):
        np.testing.assert_allclose(d_out[k].numpy(), np.asarray(d_ref[k]),
                                   rtol=1e-4, err_msg=k)
    assert d_out["nbr_overflow"].dtype == torch.int32
    _close(out.pos, ref.pos, "pos")


def test_update_h_and_current_dt_match_jax():
    jcfg, tcfg = (m.jupiter_3k(n=64, dt_mode="cfl", h_max=2.8)
                  for m in (jc, tc))
    rng = np.random.default_rng(0)
    h = rng.uniform(1.0, 3.0, 64).astype(np.float32)
    nn = rng.integers(0, 120, 64).astype(np.int32)
    nn[:4] = 0
    ref = jp.update_h(jax.numpy.asarray(h), jax.numpy.asarray(nn), jcfg)
    out = tp.update_h(torch.from_numpy(h), torch.from_numpy(nn), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    assert float(out.max()) <= 2.8 and torch.equal(out[:4].clamp(max=2.8),
                                                    out[:4])
    st = jics.rotating_planet(jcfg, omega=0.5)
    st = st.replace(accel=st.pos * 0.1)
    arrays = {k: np.asarray(v) for k, v in vars(st).items()}
    dt = tp.current_dt(tstate.from_numpy(arrays, device="cpu"), tcfg)
    assert dt.shape == () and dt.dtype == torch.float32
    np.testing.assert_allclose(float(dt), float(jp.current_dt(st, jcfg)),
                               rtol=1e-6)
    fixed = tp.current_dt(tstate.from_numpy(arrays, device="cpu"),
                          tcfg.replace(dt_mode="fixed"))
    assert fixed.shape == () and float(fixed) == np.float32(tcfg.dt)


def test_freeze_velocity_keeps_velocities():
    tcfg = tc.jupiter_3k(**BASE, freeze_velocity=True)
    st0, arrays = _start(jc.jupiter_3k(**BASE), moving=True)
    start = tp.prime(tstate.from_numpy(arrays, device="cpu"), tcfg)
    out = tp.run(start, tcfg, 2)
    assert torch.equal(out.vel, start.vel)
    assert not torch.equal(out.pos, start.pos)
    assert bool(out.accel.any())


def test_uncached_grid_prime_matches_jax():
    """compute_forces' grid branch (a fresh structure, then the block
    pipeline) on the production-stack configuration at a small size."""
    kw = dict(n=512, radius=30.0, particle_radius=3.0, neighbor_mode="grid",
              gravity_solver="tree", grad_p_mode="grad_h", h_mode="newton",
              multipole_order=2, nbr_group_size=32, nbr_sub=16,
              nbr_group_level=2, nbr_window=128, p2p_window=128,
              m2p_window=128, fuse_p2p_sph=True, fuse_p2p_residual=True)
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    st0, arrays = _start(jcfg, moving=False)
    ref = jax.jit(lambda s: jp.prime(s, jcfg))(st0)
    out = tp.prime(tstate.from_numpy(arrays, device="cpu"), tcfg)
    for k in ("rho", "h", "phi"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(out.accel.numpy(), np.asarray(ref.accel),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw,word", [
    # dense SPH + tree gravity runs, with the supergroup far tier too, and
    # cached (tests/test_torch_cached_carry.py), with any grid batching
    # and either pair dtype; a batching below 1, another pair dtype and a
    # multipole order past 2 do not
    (dict(gravity_solver="tree", kernel_gb=0), "kernel_gb"),
    (dict(gravity_solver="tree", rebuild_every=4, multipole_order=3),
     "multipole_order"),
    (dict(gravity_solver="tree", grav_pair_dtype="float16"),
     "grav_pair_dtype"),
])
def test_entry_points_refuse_unported_options_by_name(kw, word):
    cfg = tc.jupiter_3k(n=16, **kw)
    st = tstate.zeros(cfg, device="cpu")
    with pytest.raises((NotImplementedError, ValueError), match=word):
        tp.prime(st, cfg)
    with pytest.raises((NotImplementedError, ValueError), match=word):
        tp.run_info(st, cfg, 1)


def test_standalone_viscosity_sweep():
    """planet._viscosity: zero with the viscosity off, the dense module's
    sweep with it on, and a refusal by name without velocities."""
    from planetmodel_sph_tpu_torch.ops import dense as td
    cfg = tc.jupiter_3k(n=128, radius=10.0, particle_radius=3.0)
    st0, arrays = _start(jc.jupiter_3k(n=128, radius=10.0,
                                       particle_radius=3.0), moving=True)
    st = tp.prime(tstate.from_numpy(arrays, device="cpu"), cfg)
    args = (st.pos, st.vel, st.h, st.mass, st.rho)
    assert not tp._viscosity(*args, cfg).any()
    acfg = cfg.replace(av_alpha=1.0, av_beta=2.0)
    out = tp._viscosity(*args, acfg)
    assert torch.equal(out, td.viscosity_accel(*args, acfg)) and out.any()
    with pytest.raises(ValueError, match="vel"):
        tp._viscosity(st.pos, None, st.h, st.mass, st.rho, acfg)
