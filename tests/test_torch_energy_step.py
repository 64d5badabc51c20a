"""Stepping with an evolved internal energy, the port against the JAX
package: ``prime`` + 8 steps of ``run_info`` with the adiabatic and the
Tillotson EOS, at n = 1024 (grid + tree) and n = 512 (dense):

- adiabatic grid + tree, uncached: grad-h and symmetric, viscosity off (the
  three-velocity layout of pass 2) and on;
- the cached RESPA chunk with rebuild_every=4 (the merged grad-h pass 2 with
  the energy column, u through the sorted layout), and the same without
  RESPA under staggered Euler;
- dense adiabatic (symmetric and grad-h: the energy columns of
  ``ops/dense.py``), and the ``basalt_impact`` preset with the CFL timestep
  on a basalt-into-ice collision;
- Tillotson grid + tree with two materials, and a differentiated iron/basalt
  body;
- an adiabatic grid run with the supergroup far tier (sg_blocks=4).

Both packages start from the same initial conditions (made by the JAX
package, handed over as numpy arrays) and each primes them itself. pos and
vel must agree within rtol 1e-4 (atol 1e-4 of the field's scale), u within
rtol 1e-4 with an atol of 1e-5 of its largest value, h and rho within rtol
1e-4; the overflow counters and n_neighbors, n_direct, n_approx exactly.
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

# The two dense Tillotson cases take this seed: with seeds 0 and 2 one pair
# of the 512 particles sits within an ulp of q = 2 at step 4, h differs by
# one ulp between the packages (cbrt against pow), its neighbour count
# flips in one of them and the relaxed h of that particle then differs by
# 0.3 %. Everything agrees to 4e-7 up to that step.
SEED = 1
GRID = dict(n=1024, radius=30.0, particle_radius=3.0, neighbor_mode="grid",
            gravity_solver="tree", nbr_group_size=32, nbr_sub=16,
            nbr_group_level=2, nbr_window=128, p2p_window=256,
            m2p_window=128, theta=1.0, eos_mode="adiabatic")
CACHED = dict(GRID, grad_p_mode="grad_h", h_mode="newton",
              sph_refine_subblock=True, sph_refined_window=96,
              h_track_margin=0.04, fuse_p2p_sph=True, fuse_p2p_residual=True,
              multipole_order=2, grav_com_correction=True, av_alpha=1.0,
              av_beta=2.0, rebuild_every=4, respa_every=2, sort_every=8,
              nbr_window=192)
DENSE = dict(n=512, radius=20.0, particle_radius=4.0, eos_mode="adiabatic")
# cgs bodies: the basalt_impact preset, two bodies that touch
IMPACT = dict(separation=1.1e7, approach_speed=3e5,
              materials=("basalt", "ice"))
TILL_GRID = dict(vars(jc.basalt_impact(
    n=1024, neighbor_mode="grid", gravity_solver="tree", nbr_group_size=32,
    nbr_sub=16, nbr_group_level=2, nbr_window=160, p2p_window=256,
    m2p_window=128, multipole_order=1, dt_mode="fixed", dt=0.05)))

CASES = {
    "grid_gradh": (dict(GRID, grad_p_mode="grad_h"), "jupiter", {}),
    "grid_gradh_av": (dict(GRID, grad_p_mode="grad_h", av_alpha=1.0,
                           av_beta=2.0), "jupiter", {}),
    "grid_symmetric": (dict(GRID, grad_p_mode="symmetric"), "jupiter", {}),
    "grid_symmetric_av_balsara": (dict(
        GRID, grad_p_mode="symmetric", av_alpha=1.0, av_beta=2.0,
        av_balsara=True), "jupiter", {}),
    "cached_respa": (CACHED, "jupiter", {}),
    "cached_staggered": (dict(CACHED, respa_every=1,
                              integrator="staggered_euler"), "jupiter", {}),
    "dense_symmetric_av": (dict(DENSE, av_alpha=1.0, av_beta=2.0),
                           "jupiter", {}),
    "dense_gradh_av": (dict(DENSE, grad_p_mode="grad_h", av_alpha=1.0,
                            av_beta=2.0, av_balsara=True), "jupiter", {}),
    "basalt_impact_dense_cfl": (
        dict(vars(jc.basalt_impact(n=512, seed=SEED))),
        "two_planet_collision", IMPACT),
    "tillotson_grid_two_materials": (TILL_GRID, "two_planet_collision",
                                     IMPACT),
    "tillotson_differentiated": (
        dict(vars(jc.basalt_impact(n=512, dt_mode="fixed", dt=0.05,
                                   seed=SEED))),
        "differentiated_planet", {}),
    "grid_supergroups": (dict(GRID, grad_p_mode="grad_h", sg_blocks=4,
                              blk_window=64, av_alpha=1.0, av_beta=2.0),
                         "jupiter", {}),
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
    kw, ic, ic_kw = CASES[request.param]
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    uncached = dict(rebuild_every=1, respa_every=1)
    st0 = getattr(jics, ic)(jcfg, **ic_kw)
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


def test_energy_prime_matches_jax(runs):
    _, tcfg, (ref0, _, _), (out0, _, _) = runs
    _close(out0.rho, ref0.rho, 1e-5, name="rho")
    _close(out0.pressure, ref0.pressure, 1e-5, 1e-6, "pressure")
    _close(out0.accel, ref0.accel, 1e-4, 1e-5, "accel")
    _close(out0.du_dt, ref0.du_dt, 1e-4, 1e-5, "du_dt")
    _close(out0.phi, ref0.phi, 3e-5, 1e-6, "phi")
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(out0, name).numpy(),
                                      np.asarray(getattr(ref0, name)),
                                      err_msg=name)
    # priming leaves u alone; its rate is not 0 where anything moves
    np.testing.assert_array_equal(out0.u.numpy(), np.asarray(ref0.u))
    assert (float(out0.du_dt.abs().max()) > 0.0) == \
        (float(out0.vel.abs().max()) > 0.0)


def test_energy_run_info_matches_jax(runs):
    _, _, (_, ref, info_ref), (out0, out, info) = runs
    _close(out.pos, ref.pos, 1e-4, 1e-4, "pos")
    _close(out.vel, ref.vel, 1e-4, 1e-4, "vel")
    _close(out.u, ref.u, 1e-4, 1e-5, "u")
    _close(out.du_dt, ref.du_dt, 1e-3, 1e-4, "du_dt")
    _close(out.h, ref.h, 1e-4, name="h")
    _close(out.rho, ref.rho, 1e-4, 1e-6, "rho")
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_ref.items()}
    assert not np.allclose(out.u.numpy(), out0.u.numpy(), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(out.matid.numpy(), np.asarray(ref.matid))
    for k in vars(out):
        assert bool(torch.isfinite(getattr(out, k).float()).all()), k


def test_energy_counts_match_jax(runs):
    _, _, (_, ref, _), (_, out, _) = runs
    for name in COUNTS:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(
            a, b, err_msg=f"{name}: {int((a != b).sum())} particles differ")


def test_the_energy_case_runs_what_it_names(runs):
    name, tcfg, _, (out0, out, _) = runs
    assert tcfg.evolves_u
    if "two_materials" in name or "impact" in name:
        ids = set(out.matid.unique().tolist())
        assert ids == {0, 3}                          # basalt and ice
    if "differentiated" in name:
        assert set(out.matid.unique().tolist()) == {0, 2}   # basalt, iron
    if tcfg.sg_blocks > 1:
        assert int(out.n_approx.sum()) > 0
    if tcfg.dt_mode == "cfl":
        dt = float(tp.current_dt(out, tcfg))
        assert tcfg.dt_min <= dt < tcfg.dt
    assert float(out.du_dt.abs().max()) > 0.0


def test_energy_diagnostics_match_jax(runs):
    """``measure`` with the evolved u: the same energies as the reference's
    from each package's own final state."""
    from planetmodel_sph_tpu.utils import diagnostics as jdiag
    from planetmodel_sph_tpu_torch.utils import diagnostics as tdiag
    name, tcfg, (_, ref, _), (_, out, _) = runs
    jd = jdiag.measure(ref, jc.SimConfig(**CASES[name][0]))
    td = tdiag.measure(out, tcfg)
    assert set(td) == set(jd)
    scale = max(abs(float(jd[k])) for k in (
        "kinetic_energy", "potential_energy", "internal_energy"))
    for k in ("kinetic_energy", "potential_energy", "internal_energy",
              "total_energy"):
        assert abs(float(td[k]) - float(jd[k])) < 1e-4 * scale, k
    np.testing.assert_allclose(float(td["internal_energy"]),
                               float((out.mass * out.u).sum()), rtol=1e-6)
    np.testing.assert_allclose(float(td["dt_cfl_min"]),
                               float(jd["dt_cfl_min"]), rtol=1e-4)


def test_u_is_not_floored():
    """A particle in energy debt keeps its negative u through a step (the
    EOS clamps it for evaluation only)."""
    kw = dict(DENSE, n=128)
    cfg = tc.SimConfig(**kw)
    st = tstate.from_numpy({k: np.asarray(v) for k, v in vars(
        jics.jupiter(jc.SimConfig(**kw))).items()}, device="cpu")
    u = st.u.clone()
    u[:8] = -5.0
    out = tp.step_kdk(tp.prime(st.replace(u=u), cfg), cfg)
    assert bool((out.u[:8] < 0).all()) and bool(torch.isfinite(out.u).all())
    out = tp.step_staggered(tp.prime(st.replace(u=u), cfg), cfg)
    assert bool((out.u[:8] < 0).all())


def test_compute_forces_needs_u():
    cfg = tc.SimConfig(**dict(DENSE, n=64))
    z = torch.zeros(64)
    with pytest.raises(ValueError, match="needs the internal energy"):
        tp.compute_forces(torch.zeros(64, 3), z + 1, z + 1, cfg)
