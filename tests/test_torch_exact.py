"""Particle-exact SPH lists (``cfg.sph_exact_window``) in the port against
the JAX package, mirroring ``tests/test_structure.py``'s exact-list tests:

- ``build`` gives windows (sorted-layout particle ids), counts and overflow
  IDENTICAL to JAX's, far below the sub-block slot total, and counts the
  overflow of a window of 8;
- ``solve_h_newton`` builds its own exact lists (the window scaled by the
  margin's volume, or ``h_solve_window``): rtol 1e-5 (``cbrt`` against
  ``pow``, ROADMAP Queue C);
- ``forces`` match JAX's (rho rtol 2e-6, gradients 1e-4 with an atol of
  1e-6 of the field's scale, phi 3e-5, counts exact) and the port's own
  sub-block windows (the lists are transparent);
- ``gather_pad_rows`` changes no value; fully dead groups stay finite;
- ``prime`` + an 8-step ``run_info`` of the cached grad-h Newton chunk with
  exact lists match JAX (pos, vel 1e-4; rho, h 1e-4; counts and overflow
  exact).
"""

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu.models import planet as jp
from planetmodel_sph_tpu.ops import structure as js
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.models import planet as tp
from planetmodel_sph_tpu_torch.ops import structure as ts

BASE = dict(n=512, neighbor_mode="grid", gravity_solver="tree",
            nbr_group_size=64, nbr_window=128, p2p_window=128,
            m2p_window=128, nbr_group_level=2, block_chunk=512,
            sph_exact_window=640)
T = lambda a: torch.from_numpy(np.array(a))
COUNTS = ("n_neighbors", "n_direct", "n_approx")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the exact counts here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n=512, seed=13, radius=10.0):
    rng = np.random.default_rng(seed)
    pos = (radius * rng.normal(size=(n, 3))).astype(np.float32)
    h = (1.0 + rng.uniform(size=n)).astype(np.float32)
    mass = np.full(n, 0.05, np.float32)
    skin = rng.uniform(0.0, 0.2, n).astype(np.float32)
    return pos, h, mass, skin


def _cfgs(**kw):
    d = dict(BASE, **kw)
    return jc.SimConfig(**d), tc.SimConfig(**d)


def _close(a, b, rtol, scale_atol=0.0, name=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name,
                               atol=scale_atol * np.abs(b).max())


def test_exact_build_identical_to_jax():
    jcfg, tcfg = _cfgs()
    pos, h, mass, skin = _cloud()
    jst = jax.jit(lambda p, hh, m, sk: js.build(
        p, hh, m, jcfg, skin=sk, h_margin=0.04))(pos, h, mass, skin)
    tst = ts.build(T(pos), T(h), T(mass), tcfg, skin=T(skin), h_margin=0.04)
    for name in ("sph_idx", "n_sph", "sph_overflow", "p2p_idx", "n_p2p",
                 "m2p_idx", "n_m2p", "accept"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    assert int(tst.sph_overflow) == 0 and tst.sph_idx.shape[1] == 640
    # particle ids in the sorted layout, ascending in each row
    ids = tst.sph_idx.numpy()
    live = ids >= 0
    assert ids.max() < tst.groups.live.numel() and live.sum() > 0
    assert all((np.diff(r[r >= 0]) > 0).all() for r in ids)
    sub = ts.build(T(pos), T(h), T(mass), tcfg.replace(sph_exact_window=0),
                   skin=T(skin), h_margin=0.04)
    assert float(tst.n_sph.float().mean()) < 0.5 * float(
        sub.n_sph.float().mean()) * tcfg.nbr_sub


def test_exact_overflow_counted_at_window_8():
    jcfg, tcfg = _cfgs(sph_exact_window=8, gravity_solver="none")
    pos, h, mass, _ = _cloud(seed=4)
    jst = jax.jit(lambda p, hh, m: js.build(p, hh, m, jcfg))(pos, h, mass)
    tst = ts.build(T(pos), T(h), T(mass), tcfg)
    assert int(tst.sph_overflow) == int(jst.sph_overflow) > 0
    np.testing.assert_array_equal(tst.sph_idx.numpy(),
                                  np.asarray(jst.sph_idx))


@pytest.mark.parametrize("h_solve_window", [0, 768])
def test_exact_solve_h_newton_matches_jax(h_solve_window):
    jcfg, tcfg = _cfgs(grad_p_mode="grad_h", h_mode="newton",
                       h_solve_window=h_solve_window)
    pos, h, mass, _ = _cloud()
    eta = 0.55
    rho0 = np.asarray(jax.jit(lambda p, hh, m: js.forces(
        p, hh, m, jcfg, js.build(p, hh, m, jcfg)).rho)(pos, h, mass))
    for r0 in (None, rho0):
        ref = jax.jit(lambda p, hh, m, r: js.solve_h_newton(
            p, hh, m, jcfg, eta, rho0=r))(pos, h, mass, r0)
        out = ts.solve_h_newton(T(pos), T(h), T(mass), tcfg, eta,
                                rho0=None if r0 is None else T(r0))
        _close(out, ref, 1e-5)
        assert not np.allclose(out.numpy(), h)


@pytest.mark.parametrize("mode", ["grad_h", "symmetric",
                                  "reference_asymmetric"])
def test_exact_forces_match_jax(mode):
    jcfg, tcfg = _cfgs(grad_p_mode=mode)
    pos, h, mass, _ = _cloud()
    jst = jax.jit(lambda p, hh, m: js.build(p, hh, m, jcfg))(pos, h, mass)
    ref = jax.jit(lambda p, hh, m, st: js.forces(p, hh, m, jcfg, st))(
        pos, h, mass, jst)
    tst = ts.build(T(pos), T(h), T(mass), tcfg)
    out = ts.forces(T(pos), T(h), T(mass), tcfg, tst)
    _close(out.rho, ref.rho, 2e-6, name="rho")
    _close(out.grad_p, ref.grad_p, 1e-4, 1e-6, "grad_p")
    _close(out.phi, ref.phi, 3e-5, name="phi")
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6, "grad_phi")
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # transparent against the port's own sub-block windows
    sub_cfg = tcfg.replace(sph_exact_window=0)
    sub = ts.forces(T(pos), T(h), T(mass), sub_cfg,
                    ts.build(T(pos), T(h), T(mass), sub_cfg))
    _close(out.rho, sub.rho, 2e-6, name="rho vs sub-block")
    _close(out.grad_p, sub.grad_p, 1e-4, 1e-6, "grad_p vs sub-block")
    np.testing.assert_array_equal(out.n_neighbors.numpy(),
                                  sub.n_neighbors.numpy())


def test_gather_pad_rows_changes_no_value():
    """cfg.gather_pad_rows is the TPU's gather-row width: the exact lists'
    forces are identical with 0 and 32 (tests/test_structure.py:428-429
    calls it result-transparent)."""
    _, tcfg = _cfgs(grad_p_mode="grad_h", av_alpha=1.0, av_beta=2.0)
    pos, h, mass, _ = _cloud()
    vel = T(-0.05 * pos)
    st = ts.build(T(pos), T(h), T(mass), tcfg)
    a = ts.forces(T(pos), T(h), T(mass), tcfg, st, vel=vel)
    b = ts.forces(T(pos), T(h), T(mass), tcfg.replace(gather_pad_rows=32),
                  st, vel=vel)
    for x, y in zip(a, b):
        if x is not None:
            assert torch.equal(x, y)
    rows = ts._entry_gather([T(pos[:, 0]), T(h)], st.sph_idx, 512,
                            pad_rows=32)
    assert torch.equal(rows[1], ts._entry_gather([T(pos[:, 0]), T(h)],
                                                 st.sph_idx, 512)[1])


@pytest.mark.parametrize("xw", [0, 512])
def test_exact_dead_groups_stay_finite(xw):
    """Empty Morton cells give fully dead groups whose rho sits at the
    1e-30 floor, where the pressure coefficient is 0/0; the exact lists'
    single-trip sweep evaluates those rows too. Every output slot stays
    finite, and so does an 8-step cached run (the reference's
    test_dead_groups_no_nan_in_sorted_io)."""
    kw = dict(n=2048, neighbor_mode="grid", gravity_solver="tree",
              nbr_group_level=3, nbr_window=128, p2p_window=128,
              m2p_window=128, rebuild_every=4)
    if xw:
        kw.update(sph_exact_window=xw, gather_pad_rows=32)
    cfg = tc.SimConfig(**kw)
    st0 = jics.jupiter(jc.SimConfig(**kw))
    state = tstate.from_numpy({k: np.asarray(v) for k, v in vars(
        st0).items()}, device="cpu")
    st = tp._build_caches(state.pos, state.h, state.mass, state.vel, cfg,
                          accel=state.accel)
    assert int((~st.groups.live.any(dim=1)).sum()) > 0, \
        "scenario must contain fully-dead groups"
    idx = st.groups.tgt_idx.long()
    bf = ts.forces(state.pos[idx], state.h[idx], state.mass[idx], cfg, st,
                   sorted_io=True)
    for f in (bf.rho, bf.grad_p, bf.phi, bf.grad_phi):
        assert not bool(torch.isnan(f).any())
    out, info = tp.run_info(state, cfg, 8)
    assert not bool(torch.isnan(out.vel).any())
    assert float(out.rho.max()) > 1e-6
    assert int(info["nbr_overflow"]) == 0


EXACT_RUN = dict(n=1024, radius=30.0, particle_radius=3.0,
                 neighbor_mode="grid", gravity_solver="tree",
                 nbr_group_size=32, nbr_sub=16, nbr_group_level=2,
                 nbr_window=128, p2p_window=256, m2p_window=128,
                 multipole_order=2, theta=1.0, grav_com_correction=True,
                 sort_every=8, grad_p_mode="grad_h", h_mode="newton",
                 h_track_margin=0.04, rebuild_every=4, respa_every=2,
                 sph_exact_window=384, gather_pad_rows=32)


def test_exact_prime_and_run_info_match_jax():
    jcfg, tcfg = jc.SimConfig(**EXACT_RUN), tc.SimConfig(**EXACT_RUN)
    uncached = dict(rebuild_every=1, respa_every=1)
    st0 = jics.jupiter(jcfg)
    arrays = {k: np.asarray(v) for k, v in vars(st0).items()}
    ref0 = jax.jit(lambda s: jp.prime(s, jcfg.replace(**uncached)))(st0)
    ref, info_ref = jp.run_info(ref0, jcfg, 8)
    out0 = tp.prime(tstate.from_numpy(arrays, device="cpu"),
                    tcfg.replace(**uncached))
    out, info = tp.run_info(out0, tcfg, 8)
    _close(out0.rho, ref0.rho, 1e-5, name="prime rho")
    _close(out.pos, ref.pos, 1e-4, 1e-4, "pos")
    _close(out.vel, ref.vel, 1e-4, 1e-4, "vel")
    _close(out.h, ref.h, 1e-4, name="h")
    _close(out.rho, ref.rho, 1e-4, 1e-6, "rho")
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_ref.items()} == \
        {"nbr_overflow": 0, "tree_overflow": 0}
    assert not np.allclose(out.pos.numpy(), out0.pos.numpy())
