"""The general grid + tree step and the runners that reach it, the port
against the JAX package: ``prime`` + 8 steps of ``run_info`` in the
configurations the card runs at n = 100,000, here at n = 1024 (and the
``parity`` preset at n = 512):

- `sym`: the unfused symmetric step with relax-mode h in cached RESPA
  chunks (pass1_sym, symmetric pass 2 without gravity, the standalone P2P
  sweep on inner steps, the far-only launch once per period), and the same
  with respa_every=1 (every tier in one launch each step);
- `settle`: the drift protocol's settle phase from a raw polytrope: grad-h
  with Newton h, Monaghan viscosity, velocity damping, respa_every=1, with
  and without the Balsara limiter;
- `parity`: dense SPH with the sign bug and the asymmetric gradient, tree
  gravity with receiver softening from a fresh structure per step,
  staggered Euler, uncached;
- staggered Euler inside a cached chunk, and a grid run without gravity.

Both packages start from the same initial conditions (made by the JAX
package, handed over as numpy arrays) and each primes them itself. pos and
vel must agree within rtol 1e-4 (atol 1e-4 of the field's scale), h and rho
within rtol 1e-4, the overflow counters exactly; n_neighbors, n_direct and
n_approx exactly, after the priming pass and after the 8 steps (in every
case here no particle's count differs; one torch thread keeps it so).
"""

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

GRID = dict(n=1024, radius=30.0, particle_radius=3.0, neighbor_mode="grid",
            gravity_solver="tree", nbr_group_size=32, nbr_sub=16,
            nbr_group_level=2, nbr_window=128, p2p_window=256,
            m2p_window=128, multipole_order=2, theta=1.0,
            grav_com_correction=True, sort_every=8)
SYM = dict(GRID, grad_p_mode="symmetric", h_mode="relax",
           sph_refine_subblock=True, sph_refined_window=64,
           h_track_margin=0.04, rebuild_every=4, respa_every=2)
SETTLE = dict(GRID, grad_p_mode="grad_h", h_mode="newton",
              sph_refine_subblock=True, sph_refined_window=96,
              h_track_margin=0.04, fuse_p2p_sph=True,
              fuse_p2p_residual=True, vel_damping=0.1, av_alpha=0.5,
              av_beta=1.0, rebuild_every=4, respa_every=1, h_max=5.0,
              nbr_window=192)
CASES = {
    "sym_respa": (SYM, "jupiter"),
    "sym_every_tier": (dict(SYM, respa_every=1), "jupiter"),
    "sym_fused_unmerged": (dict(SYM, fuse_p2p_sph=True), "jupiter"),
    "settle_av": (SETTLE, "polytrope"),
    "settle_av_balsara": (dict(SETTLE, av_balsara=True), "polytrope"),
    "staggered_in_chunk": (dict(SYM, respa_every=1,
                                integrator="staggered_euler"), "jupiter"),
    "grid_no_gravity_uncached": (dict(
        GRID, gravity_solver="none", grad_p_mode="symmetric",
        grav_com_correction=False, sort_every=0), "jupiter"),
    "grid_uncached_asymmetric_av": (dict(
        GRID, grad_p_mode="reference_asymmetric",
        kernel_deriv_sign_bug=True, softening_mode="receiver_h",
        av_alpha=1.0, av_beta=2.0, av_balsara=True, sort_every=0,
        integrator="staggered_euler"), "jupiter"),
    "parity": (dict(vars(tc.parity(n=512, radius=20.0,
                                   particle_radius=4.0,
                                   nbr_group_level=2))), "jupiter"),
}
STEPS = 8
COUNTS = ("n_neighbors", "n_direct", "n_approx")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the exact counts here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    kw, ic = CASES[request.param]
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    uncached = dict(rebuild_every=1, respa_every=1)
    st0 = getattr(jics, ic)(jcfg)
    arrays = {k: np.asarray(v) for k, v in vars(st0).items()}
    ref0 = jax.jit(lambda s: jp.prime(s, jcfg.replace(**uncached)))(st0)
    ref, info_ref = jp.run_info(ref0, jcfg, STEPS)
    jax.block_until_ready(ref)
    out0 = tp.prime(tstate.from_numpy(arrays, device="cpu"),
                    tcfg.replace(**uncached))
    out, info = tp.run_info(out0, tcfg, STEPS)
    return request.param, tcfg, (ref0, ref, info_ref), (out0, out, info)


def _close(a, b, rtol, scale_atol=0.0, name=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name,
                               atol=scale_atol * np.abs(b).max())


def test_prime_matches_jax(runs):
    _, tcfg, (ref0, _, _), (out0, _, _) = runs
    _close(out0.rho, ref0.rho, 1e-5, name="rho")
    _close(out0.accel, ref0.accel, 1e-4, 1e-5, "accel")
    _close(out0.phi, ref0.phi, 3e-5, 1e-6, "phi")
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(out0, name).numpy(),
                                      np.asarray(getattr(ref0, name)),
                                      err_msg=name)
    _close(out0.balsara, ref0.balsara, 1e-4, 1e-6, "balsara")
    if tcfg.av_balsara:
        assert float(out0.balsara.min()) < 1.0


def test_run_info_matches_jax(runs):
    _, _, (_, ref, info_ref), (out0, out, info) = runs
    _close(out.pos, ref.pos, 1e-4, 1e-4, "pos")
    _close(out.vel, ref.vel, 1e-4, 1e-4, "vel")
    _close(out.h, ref.h, 1e-4, name="h")
    _close(out.rho, ref.rho, 1e-4, 1e-6, "rho")
    _close(out.balsara, ref.balsara, 1e-3, 1e-4, "balsara")
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_ref.items()}
    assert not np.allclose(out.pos.numpy(), out0.pos.numpy())
    for k in vars(out):
        assert bool(torch.isfinite(getattr(out, k).float()).all()), k


def test_counts_match_jax(runs):
    _, _, (_, ref, _), (_, out, _) = runs
    for name in COUNTS:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(
            a, b, err_msg=f"{name}: {int((a != b).sum())} particles differ")


def test_the_case_runs_what_it_names(runs):
    name, tcfg, _, (_, out, _) = runs
    if tcfg.gravity_solver == "none":
        for k in ("phi", "grad_phi", "n_direct", "n_approx"):
            assert float(getattr(out, k).abs().sum()) == 0.0, k
    else:
        assert int(out.n_direct.sum()) > 0 and int(out.n_approx.sum()) > 0
    nn = float(out.n_neighbors.float().mean())
    assert 10.0 < nn < 120.0, nn


def test_forces_fix_fbal_and_com_correct():
    """compute_forces hands the Balsara factors to the grid branch (they
    change the viscosity), and applies the centre-of-mass correction on the
    dense branch with tree gravity."""
    kw = dict(CASES["grid_uncached_asymmetric_av"][0])
    cfg = tc.SimConfig(**kw)
    st = tstate.from_numpy({k: np.asarray(v) for k, v in vars(
        jics.jupiter(jc.SimConfig(**kw))).items()}, device="cpu")
    vel = st.pos * -0.05
    ones = tp.compute_forces(st.pos, st.h, st.mass, cfg, vel=vel,
                             fbal=torch.ones_like(st.h))
    half = tp.compute_forces(st.pos, st.h, st.mass, cfg, vel=vel,
                             fbal=torch.full_like(st.h, 0.5))
    none = tp.compute_forces(st.pos, st.h, st.mass, cfg, vel=vel)
    assert torch.equal(none.accel, ones.accel)
    assert not torch.allclose(half.accel, ones.accel)
    assert ones.balsara is not None

    pcfg = tc.parity(n=512, radius=20.0, particle_radius=4.0,
                     nbr_group_level=2, grav_com_correction=True)
    pst = tstate.from_numpy({k: np.asarray(v) for k, v in vars(
        jics.jupiter(jc.parity(n=512, radius=20.0,
                               particle_radius=4.0))).items()},
        device="cpu")
    f = tp.compute_forces(pst.pos, pst.h, pst.mass, pcfg)
    net = (pst.mass[:, None] * f.grad_phi).sum(dim=0)
    raw = tp.compute_forces(pst.pos, pst.h, pst.mass,
                            pcfg.replace(grav_com_correction=False))
    net_raw = (pst.mass[:, None] * raw.grad_phi).sum(dim=0)
    assert float(net.abs().max()) < 0.05 * float(net_raw.abs().max())
    assert f.overflow is not None and int(f.n_approx.sum()) > 0


def test_runner_refusals():
    """What the cached runner still refuses, by name (the cached dense
    step and unsorted chunks are ported: tests/test_torch_cached_carry.py)."""
    with pytest.raises(ValueError, match="kernel_gb"):
        tp.run_info(None, tc.SimConfig(**dict(SYM, sorted_chunks=False,
                                              kernel_gb=0)), 4)
    with pytest.raises(NotImplementedError, match="direct"):
        tp.run_info(None, tc.SimConfig(**dict(SYM,
                                              gravity_solver="direct")), 4)


def test_respa_needs_the_kdk_tree_pipeline():
    cfg = tc.SimConfig(**dict(SYM, integrator="staggered_euler"))
    kw = dict(CASES["sym_respa"][0])
    st = tstate.from_numpy({k: np.asarray(v) for k, v in vars(
        jics.jupiter(jc.SimConfig(**kw))).items()}, device="cpu")
    with pytest.raises(ValueError, match="respa_every"):
        tp.run_info(st, cfg, 4)
