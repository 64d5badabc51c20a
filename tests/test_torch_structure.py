"""The port's block structure and sweeps against the JAX package's.

Production-stack configuration of tests/test_structure.py (sub-block
windows + true-pair refine + truncation, tracked-h margin, quadrupole far
field, fused residual P2P) at n=1024. Window indices, counts and overflow
counters must be IDENTICAL; forces match within the tolerances of
tests/test_structure.py (rho rtol 2e-6; gradients rtol 1e-4 with an atol
of 1e-6 of the field's scale; phi rtol 3e-5).
"""

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.ops import structure as js
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import structure as ts

KW = dict(n=1024, radius=30.0, particle_radius=3.0, neighbor_mode="grid",
          gravity_solver="tree", grad_p_mode="grad_h", h_mode="newton",
          h_track_margin=0.04, sph_refine_subblock=True,
          sph_refined_window=64, rebuild_every=4, respa_every=2,
          multipole_order=2, nbr_group_size=32, nbr_sub=16,
          nbr_group_level=2, nbr_window=128, p2p_window=128,
          m2p_window=128, fuse_p2p_sph=True, fuse_p2p_residual=True)
JCFG = jc.SimConfig(**KW)
TCFG = tc.SimConfig(**KW)
T = lambda a: torch.from_numpy(np.array(a))


def _cloud(seed=0, n=1024):
    rng = np.random.default_rng(seed)
    pos = (8.0 * rng.normal(size=(n, 3))).astype(np.float32)
    h = (1.0 + rng.uniform(size=n)).astype(np.float32)
    mass = np.full(n, 0.05, np.float32)
    mass[::97] = 0.0                       # a few massless particles
    skin = rng.uniform(0.0, 0.2, n).astype(np.float32)
    return pos, h, mass, skin


@pytest.fixture(scope="module")
def built():
    pos, h, mass, skin = _cloud()
    jst = jax.jit(lambda p, hh, m, sk: js.build(
        p, hh, m, JCFG, skin=sk, h_margin=0.04))(pos, h, mass, skin)
    tst = ts.build(T(pos), T(h), T(mass), TCFG, skin=T(skin),
                   h_margin=0.04)
    return (pos, h, mass), jst, tst


def _close(a, b, rtol, scale_atol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=scale_atol * np.abs(b).max())


def test_build_windows_identical(built):
    _, jst, tst = built
    for name in ("tgt_idx", "live", "scatter_to", "order", "unsort_idx"):
        np.testing.assert_array_equal(
            getattr(tst.groups, name).numpy(),
            np.asarray(getattr(jst.groups, name)), err_msg=name)
    for name in ("sph_idx", "n_sph", "p2p_idx", "n_p2p", "m2p_idx",
                 "n_m2p", "accept", "sph_overflow", "p2p_overflow",
                 "m2p_overflow"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    # every tier is populated, so the comparison is not vacuous
    assert int(tst.n_sph.sum()) and int(tst.n_p2p.sum()) \
        and int(tst.n_m2p.sum()) and float(tst.accept.sum())


def test_build_overflow_counted_identically():
    pos, h, mass, skin = _cloud(1)
    small = dict(nbr_window=8, p2p_window=6, m2p_window=4)
    jcfg = JCFG.replace(**small)
    jst = jax.jit(lambda p, hh, m, sk: js.build(p, hh, m, jcfg, skin=sk))(
        pos, h, mass, skin)
    tst = ts.build(T(pos), T(h), T(mass), TCFG.replace(**small),
                   skin=T(skin))
    ref = {k: int(v) for k, v in js.overflow_info(jst).items()}
    out = {k: int(v) for k, v in ts.overflow_info(tst).items()}
    assert out == ref and out["nbr_overflow"] > 0 \
        and out["tree_overflow"] > 0


def test_forces_sorted_near_matches(built):
    (pos, h, mass), jst, tst = built
    idx = np.asarray(jst.groups.tgt_idx)
    ps, hs, ms = pos[idx], h[idx], mass[idx]
    ref = jax.jit(lambda p, hh, m, st: js.forces(
        p, hh, m, JCFG, st, sorted_io=True, grav_tiers="near"))(
        ps, hs, ms, jst)
    out = ts.forces(T(ps), T(hs), T(ms), TCFG, tst, sorted_io=True,
                    grav_tiers="near")
    _close(out.rho, ref.rho, 2e-6)
    _close(out.pressure, ref.pressure, 5e-6)
    np.testing.assert_array_equal(out.n_neighbors.numpy(),
                                  np.asarray(ref.n_neighbors))
    np.testing.assert_array_equal(out.n_direct.numpy(),
                                  np.asarray(ref.n_direct))
    _close(out.grad_p, ref.grad_p, 1e-4, 1e-6)
    _close(out.phi, ref.phi, 3e-5)
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)


def test_forces_all_tiers_unsorted_matches(built):
    (pos, h, mass), jst, tst = built
    ref = jax.jit(lambda p, hh, m, st: js.forces(p, hh, m, JCFG, st))(
        pos, h, mass, jst)
    out = ts.forces(T(pos), T(h), T(mass), TCFG, tst)
    _close(out.rho, ref.rho, 2e-6)
    _close(out.phi, ref.phi, 3e-5)
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)
    for name in ("n_neighbors", "n_direct", "n_approx"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_gravity_far_matches(built):
    (pos, h, mass), jst, tst = built
    ref = jax.jit(lambda p, hh, m, st: js.gravity_far(
        p, hh, m, JCFG, st))(pos, h, mass, jst)
    out = ts.gravity_far(T(pos), T(h), T(mass), TCFG, tst)
    _close(out[0], ref[0], 3e-5)
    _close(out[1], ref[1], 1e-4, 1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert int(out[2].sum()) > 0


def test_solve_h_newton_matches(built):
    (pos, h, mass), _, _ = built
    eta = 0.55
    rho0 = np.asarray(jax.jit(lambda p, hh, m: js.forces(
        p, hh, m, JCFG, js.build(p, hh, m, JCFG)).rho)(pos, h, mass))
    solve = jax.jit(lambda p, hh, m, r0: js.solve_h_newton(
        p, hh, m, JCFG, eta, rho0=r0))
    for r0 in (None, rho0):
        ref = solve(pos, h, mass, r0)
        out = ts.solve_h_newton(T(pos), T(h), T(mass), TCFG, eta,
                                rho0=None if r0 is None else T(r0))
        # cbrt (JAX) against pow(., 1/3) (PyTorch): an ulp per iteration
        _close(out, ref, 1e-5)


def test_out_of_slice_config_refused():
    pos, h, mass, _ = _cloud()
    # the unfused partition, the supergroup tier and particle-exact lists
    # are ported (tests/test_torch_gravity_tiers.py,
    # tests/test_torch_exact.py); the TPU's grid batching is still
    # refused, and the fusion still refuses exact lists and the
    # supergroup tier
    with pytest.raises(ValueError, match="sph_exact_window"):
        ts.build(T(pos), T(h), T(mass), TCFG.replace(sph_exact_window=512))
    with pytest.raises(ValueError, match="kernel_gb"):
        ts.build(T(pos), T(h), T(mass), TCFG.replace(kernel_gb=8))
    with pytest.raises(ValueError, match="sg_blocks"):
        ts.build(T(pos), T(h), T(mass), TCFG.replace(sg_blocks=4))
