"""The port's initial conditions. Its random stream is PyTorch's, not the
JAX package's threefry, so the particles themselves cannot be compared:
these tests hold the properties the JAX generators guarantee (geometry, h
range, masses, determinism, the polytrope's radial distribution) and the
field-by-field layout against the JAX state."""

import dataclasses
import math

import numpy as np
import pytest
import torch
from scipy import stats

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.models import ics
from planetmodel_sph_tpu_torch.ops import eos as eos_ops

CFG = tc.jupiter_3k(n=2000, seed=4)


def _radii(pos):
    return torch.linalg.norm(pos, dim=-1).numpy()


@pytest.mark.parametrize("method", ["rejection", "direct"])
def test_uniform_sphere_is_uniform_in_the_ball(method):
    gen = torch.Generator().manual_seed(1)
    pts = ics.uniform_sphere(gen, 4000, 7.0, method=method)
    assert pts.shape == (4000, 3) and pts.dtype == torch.float32
    r = _radii(pts)
    assert r.max() < 7.0
    # P(R < r) = (r/7)^3
    assert stats.kstest(r, lambda x: (x / 7.0) ** 3).pvalue > 1e-3
    assert abs(float(pts.mean())) < 0.2


def test_uniform_sphere_refuses_unknown_method():
    with pytest.raises(ValueError, match="method"):
        ics.uniform_sphere(torch.Generator(), 4, 1.0, method="grid")


def test_jupiter_geometry_h_range_and_mass():
    st = ics.jupiter(CFG, device="cpu")
    assert _radii(st.pos).max() < CFG.radius
    lo = CFG.particle_radius / CFG.kappa
    assert float(st.h.min()) >= lo and float(st.h.max()) < 1.5 * lo
    assert float(st.h.max()) > 1.4 * lo                 # the range is used
    np.testing.assert_allclose(float(st.mass.sum()), CFG.total_mass,
                               rtol=1e-5)
    rho0 = CFG.total_mass / (4.0 / 3.0 * math.pi * CFG.radius ** 3)
    np.testing.assert_allclose(st.rho.numpy(), rho0, rtol=1e-6)
    np.testing.assert_allclose(st.pressure.numpy(),
                               CFG.eos_k * rho0 ** 2, rtol=1e-6)
    assert not st.vel.any() and not st.accel.any()
    assert bool((st.balsara == 1).all())


def test_state_layout_matches_jax():
    """Same fields, shapes and dtypes as the JAX package's state."""
    ref = jics.jupiter(jc.jupiter_3k(n=300))
    out = ics.jupiter(tc.jupiter_3k(n=300), device="cpu")
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        assert tuple(a.shape) == tuple(b.shape), f.name
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), f.name
    # deterministic fields agree in value as well
    for k in ("mass", "rho", "pressure", "u"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-6)


def test_same_seed_same_particles_other_seed_other_particles():
    a = ics.jupiter(CFG, device="cpu")
    b = ics.jupiter(CFG, device="cpu")
    c = ics.jupiter(CFG.replace(seed=5), device="cpu")
    for k in tstate.FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert not torch.equal(a.pos, c.pos) and not torch.equal(a.h, c.h)


def test_polytrope_radii_follow_the_analytic_cdf():
    cfg = tc.default(n=4000, seed=2, gravity_solver="direct")
    st = ics.polytrope(cfg, device="cpu")
    r1 = ics.polytrope_radius(cfg)
    np.testing.assert_allclose(
        r1, math.pi * math.sqrt(cfg.eos_k / (2 * math.pi)), rtol=1e-12)
    r = _radii(st.pos)
    assert r.max() <= r1 * (1 + 1e-5)

    def cdf(x):
        xi = np.pi * np.asarray(x) / r1
        return (np.sin(xi) - xi * np.cos(xi)) / np.pi
    assert stats.kstest(r, cdf).pvalue > 1e-3
    # rho follows rho_c sin(xi)/xi at each particle's radius; h follows it
    rho_c = cfg.total_mass * math.pi ** 2 / (4.0 * r1 ** 3)
    xi = np.pi * r / r1
    np.testing.assert_allclose(st.rho.numpy(), rho_c * np.sinc(xi / np.pi),
                               rtol=2e-3, atol=1e-4 * rho_c)
    assert float(st.h.min()) > 0 and not st.vel.any()


def test_polytrope_matches_jax_profile():
    """Different particles, same profile: the JAX polytrope's radii pass
    the same test against the port's radii (two-sample KS)."""
    kw = dict(n=3000, seed=2)
    ref = jics.polytrope(jc.default(**kw))
    out = ics.polytrope(tc.default(**kw), device="cpu")
    r_ref = np.linalg.norm(np.asarray(ref.pos), axis=-1)
    assert stats.ks_2samp(_radii(out.pos), r_ref).pvalue > 1e-3
    np.testing.assert_allclose(float(out.h.mean()),
                               float(np.asarray(ref.h).mean()), rtol=0.02)


@pytest.mark.parametrize("n", [200, 201])
def test_two_planet_collision_split_and_momentum(n):
    cfg = tc.jupiter_3k(n=n, radius=10.0, particle_radius=2.0)
    st = ics.two_planet_collision(cfg, separation=60.0, approach_speed=0.8,
                                  impact_parameter=4.0, device="cpu")
    n_a = (n + 1) // 2
    assert st.pos.shape == (n, 3)
    for f in tstate.FIELDS:
        assert getattr(st, f).shape[0] == n, f
    np.testing.assert_allclose(float(st.mass.sum()), cfg.total_mass,
                               rtol=1e-5)
    assert torch.equal(st.mass, torch.full((n,), st.mass[0].item()))
    assert bool((st.vel[:n_a, 0] == 0.4).all())
    assert bool((st.vel[n_a:, 0] == -0.4).all())
    # bodies sit at -+(30, 2, 0), each inside its own ball
    ca = st.pos[:n_a] + torch.tensor([30.0, 2.0, 0.0])
    cb = st.pos[n_a:] - torch.tensor([30.0, 2.0, 0.0])
    assert _radii(ca).max() < 10.0 and _radii(cb).max() < 10.0
    mom = (st.mass[:, None] * st.vel).sum(dim=0)
    # equal split: zero; odd n: one particle's worth along x
    assert float(mom.abs().max()) <= 0.4 * float(st.mass[0]) * (n % 2) + 1e-6
    ref = jics.two_planet_collision(jc.jupiter_3k(n=n, radius=10.0,
                                                  particle_radius=2.0))
    assert tuple(ref.pos.shape) == (n, 3)


def test_rotating_planet_is_solid_body_rotation():
    st = ics.rotating_planet(CFG, omega=0.05, device="cpu")
    base = ics.jupiter(CFG, device="cpu")
    assert torch.equal(st.pos, base.pos)
    np.testing.assert_allclose(st.vel[:, 0].numpy(),
                               (-0.05 * st.pos[:, 1]).numpy(), rtol=1e-6)
    np.testing.assert_allclose(st.vel[:, 1].numpy(),
                               (0.05 * st.pos[:, 0]).numpy(), rtol=1e-6)
    assert not st.vel[:, 2].any()


@pytest.mark.parametrize("call,word", [
    (lambda: ics.differentiated_planet(CFG, device="cpu"), "tillotson"),
    (lambda: ics.two_planet_collision(
        CFG.replace(eos_mode="tillotson"), materials=("basalt", "slate"),
        device="cpu"), "slate"),
    (lambda: ics.jupiter(CFG.replace(eos_mode="tillotson",
                                     material="slate"), device="cpu"),
     "slate"),
])
def test_unported_initial_conditions_refused_by_name(call, word):
    """Every initial condition is ported; what they refuse is what the
    reference refuses: a differentiated body without the Tillotson EOS,
    and a material that is not in the table."""
    with pytest.raises((ValueError, KeyError), match=word):
        call()


TILL = tc.basalt_impact(n=1001, seed=3)


def test_init_u_and_matid_follow_the_eos():
    """_init_u: cfg.u0 under tillotson, the polytropic relation otherwise;
    _init_matid: cfg.material's id."""
    rho = torch.tensor([0.5, 2.0])
    assert torch.equal(ics._init_u(TILL, rho), torch.full_like(rho, 1e9))
    assert torch.equal(ics._init_u(CFG.replace(eos_mode="adiabatic"), rho),
                       CFG.eos_k * rho)
    assert ics._init_matid(TILL.replace(material="ice"), 3).tolist() == [3] * 3
    assert ics._init_matid(TILL, 3).dtype == torch.int32
    st = ics.jupiter(TILL.replace(material="iron"), device="cpu")
    assert set(st.matid.tolist()) == {2} and set(st.u.tolist()) == {1e9}


@pytest.mark.parametrize("materials", [("basalt", "ice"), ("iron", "basalt"),
                                       None])
def test_two_planet_collision_materials_match_jax(materials):
    """Per-body materials: each body's radius from its material's rho0,
    equal particle masses, material ids by body; the same distribution as
    the reference's (same counts, extents and bulk velocities)."""
    jcfg = jc.basalt_impact(n=TILL.n, seed=3)
    kw = dict(separation=2e7, approach_speed=3e5, materials=materials)
    ref = jics.two_planet_collision(jcfg, **kw)
    st = ics.two_planet_collision(TILL, device="cpu", **kw)
    n_a = (TILL.n + 1) // 2
    names = materials or ("basalt", "basalt")
    for sl, name, sign in ((slice(0, n_a), names[0], -1.0),
                           (slice(n_a, None), names[1], 1.0)):
        mid = eos_ops.material_index(name)
        assert set(st.matid[sl].tolist()) == {mid}
        np.testing.assert_array_equal(st.matid[sl].numpy(),
                                      np.asarray(ref.matid[sl]))
        centre = torch.tensor([sign * 1e7, 0.0, 0.0])
        r = torch.linalg.norm(st.pos[sl] - centre, dim=-1)
        r_ref = np.linalg.norm(np.asarray(ref.pos[sl])
                               - centre.numpy(), axis=-1)
        m_body = float(st.mass[sl].sum())
        want = (3.0 * m_body / (4.0 * np.pi * eos_ops.material_rho0(name))
                ) ** (1.0 / 3.0) if materials else TILL.radius
        assert float(r.max()) <= want * (1 + 1e-5)
        assert float(r.max()) > 0.9 * want
        np.testing.assert_allclose(float(r.max()), r_ref.max(), rtol=0.05)
        # pressure-free start: the IC density is the material's rho0
        if materials:
            np.testing.assert_allclose(
                float(st.rho[sl][0]), eos_ops.material_rho0(name), rtol=1e-5)
        np.testing.assert_allclose(st.rho[sl].numpy(),
                                   np.asarray(ref.rho[sl]), rtol=1e-5)
        np.testing.assert_allclose(st.h[sl].mean().item(),
                                   np.asarray(ref.h[sl]).mean(), rtol=0.02)
    np.testing.assert_allclose(st.mass.numpy(), np.asarray(ref.mass),
                               rtol=1e-6)
    assert float(st.mass.max() / st.mass.min()) < 1.0 + 1e-5
    np.testing.assert_array_equal(st.vel.numpy(), np.asarray(ref.vel))
    np.testing.assert_array_equal(st.u.numpy(), np.asarray(ref.u))


@pytest.mark.parametrize("kw", [{}, dict(core_material="iron",
                                         mantle_material="ice",
                                         core_mass_frac=0.5)],
                         ids=["iron_basalt", "iron_ice_half"])
def test_differentiated_planet_matches_jax(kw):
    """Counts per material, shell radii from the materials' rho0, equal
    particle masses, a pressure-free start: the reference's, field by
    field where no random number enters."""
    jcfg = jc.basalt_impact(n=TILL.n, seed=3)
    ref = jics.differentiated_planet(jcfg, **kw)
    st = ics.differentiated_planet(TILL, device="cpu", **kw)
    for name in ("mass", "rho", "h", "u", "pressure"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=2e-6, atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(st.matid.numpy(), np.asarray(ref.matid))
    core = kw.get("core_material", "iron")
    n_core = int((st.matid == eos_ops.material_index(core)).sum())
    assert n_core == round(TILL.n * kw.get("core_mass_frac", 0.3))
    assert float(st.mass.max() / st.mass.min()) < 1.01
    r = torch.linalg.norm(st.pos, dim=-1)
    r_ref = np.linalg.norm(np.asarray(ref.pos), axis=-1)
    # the core fills its ball, the mantle its shell, as the reference's
    np.testing.assert_allclose(float(r[:n_core].max()),
                               r_ref[:n_core].max(), rtol=0.02)
    np.testing.assert_allclose(float(r[n_core:].min()),
                               r_ref[n_core:].min(), rtol=0.02)
    np.testing.assert_allclose(float(r.max()), r_ref.max(), rtol=0.01)
    assert float(r[:n_core].max()) <= float(r[n_core:].min()) * (1 + 1e-6)
    # cold material at its reference density: no pressure to speak of
    a_scale = eos_ops.TILLOTSON_MATERIALS[core][3]
    assert float(st.pressure.abs().max()) < 0.02 * a_scale
    assert not st.vel.any()
    for name in ("pos", "h"):
        assert getattr(st, name).dtype == torch.float32

