"""The port's equations of state against the JAX package's, on the same
numpy (rho, u) grids.

The Tillotson grid crosses all three branches for every material: rho from
vacuum through 0.5 rho0 (expanded), the cold-expanded cutoff at 0.8 rho0, to
2 rho0 (condensed); u from 0 through e_iv and e_cv to 5 e_cv (condensed,
hybrid, expanded), with u = 0, u = e_iv and u = e_cv exactly on the grid.
Pressure: rtol 1e-5 with an absolute floor of 1e-6 A (the terms A mu and
B mu^2 cancel near rho0, and A sets their scale). Sound speed: rtol 1e-4
(its partials come from forward-mode differentiation in the JAX package and
are written out by hand in the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.ops import eos as je
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import eos as te

MATERIALS = tuple(je.TILLOTSON_MATERIALS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(material):
    rho0, _, _, _, _, _, e_iv, e_cv = je.TILLOTSON_MATERIALS[material][:8]
    rho = rho0 * np.array([1e-6, 1e-3, 0.1, 0.5, 0.79, 0.8, 0.81, 0.95,
                           0.999, 1.0, 1.001, 1.2, 2.0], np.float32)
    u = np.concatenate([
        [0.0, 1e6, 1e9], e_iv * np.array([0.5, 0.999, 1.0, 1.001]),
        np.linspace(e_iv, e_cv, 7)[1:-1],
        e_cv * np.array([0.999, 1.0, 1.001, 2.0, 5.0])]).astype(np.float32)
    r, e = np.meshgrid(rho, u, indexing="ij")
    return r.reshape(-1), e.reshape(-1)


def test_tables_are_the_references():
    assert te.TILLOTSON_MATERIALS == je.TILLOTSON_MATERIALS
    assert te.MATERIAL_NAMES == je.MATERIAL_NAMES
    assert te.MATERIAL_INDEX == je.MATERIAL_INDEX
    assert te.TILLOTSON_ETA_FLOOR == je.TILLOTSON_ETA_FLOOR
    for name in MATERIALS:
        assert te.material_index(name) == je.material_index(name)
        assert te.material_rho0(name) == pytest.approx(
            float(je.material_rho0(name)))
    ids = np.array([4, 0, 3, 3, 1, 2], np.int32)
    np.testing.assert_allclose(
        te.material_rho0(torch.from_numpy(ids)).numpy(),
        np.asarray(je.material_rho0(jnp.asarray(ids))))


@pytest.mark.parametrize("material", MATERIALS)
def test_tillotson_pressure_matches_jax(material):
    rho, u = _grid(material)
    a_scale = je.TILLOTSON_MATERIALS[material][3]
    ref = np.asarray(je.tillotson_pressure(jnp.asarray(rho), jnp.asarray(u),
                                           material))
    out = te.tillotson_pressure(torch.from_numpy(rho), torch.from_numpy(u),
                                material).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6 * a_scale)
    # all three branches are on the grid
    rho0, e_iv, e_cv = (je.TILLOTSON_MATERIALS[material][k] for k in (0, 6, 7))
    exp = rho < rho0
    assert (exp & (u >= e_cv)).any() and (exp & (u > e_iv) & (u < e_cv)).any()
    assert (~exp).any() and (exp & (u <= e_iv)).any()
    assert np.abs(ref).max() > a_scale * 0.1


@pytest.mark.parametrize("material", MATERIALS)
def test_tillotson_sound_speed_matches_jax(material):
    rho, u = _grid(material)
    ref = np.asarray(je.tillotson_sound_speed(jnp.asarray(rho),
                                              jnp.asarray(u), material))
    out = te.tillotson_sound_speed(torch.from_numpy(rho),
                                   torch.from_numpy(u), material).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    rho0, a_scale = (je.TILLOTSON_MATERIALS[material][k] for k in (0, 3))
    floor = np.sqrt(1e-6 * a_scale / rho0)
    assert out.min() >= floor * (1 - 1e-6) and out.max() > 100 * floor


def test_mixed_matid_matches_jax_and_the_named_path():
    """A per-particle matid tensor: one table gather, every constant a
    tensor; the same values as the scalar path material by material."""
    parts = [(m, *_grid(m)) for m in MATERIALS]
    rho = np.concatenate([p[1] for p in parts])
    u = np.concatenate([p[2] for p in parts])
    mid = np.concatenate([np.full(len(p[1]), je.material_index(p[0]),
                                  np.int32) for p in parts])
    perm = np.random.default_rng(0).permutation(len(rho))
    rho, u, mid = rho[perm], u[perm], mid[perm]
    tr, tu, tm = (torch.from_numpy(x) for x in (rho, u, mid))
    a_scale = np.array([m[3] for m in je.TILLOTSON_MATERIALS.values()],
                       np.float32)[mid]
    p_ref = np.asarray(je.tillotson_pressure(jnp.asarray(rho),
                                             jnp.asarray(u),
                                             jnp.asarray(mid)))
    p_out = te.tillotson_pressure(tr, tu, tm).numpy()
    assert np.all(np.abs(p_out - p_ref) <= 1e-5 * np.abs(p_ref)
                  + 1e-6 * a_scale)
    c_ref = np.asarray(je.tillotson_sound_speed(
        jnp.asarray(rho), jnp.asarray(u), jnp.asarray(mid)))
    c_out = te.tillotson_sound_speed(tr, tu, tm)
    np.testing.assert_allclose(c_out.numpy(), c_ref, rtol=1e-4)
    for name in MATERIALS:
        sel = torch.from_numpy(mid == je.material_index(name))
        named = te.tillotson_pressure(tr[sel], tu[sel], name)
        # (Python-float constants there, f32 table rows here)
        np.testing.assert_allclose(
            p_out[sel.numpy()], named.numpy(), rtol=1e-5,
            atol=1e-6 * je.TILLOTSON_MATERIALS[name][3])
    # an int64 matid gathers the same rows
    assert torch.equal(te.tillotson_pressure(tr, tu, tm.long()),
                       te.tillotson_pressure(tr, tu, tm))


@pytest.mark.parametrize("material", MATERIALS)
def test_tillotson_finite_at_vacuum_and_cold(material):
    """rho = 0, rho = 1e-20 and u = 0 (also a small negative energy debt):
    the clamps keep the unselected branches' derivatives finite."""
    rho = np.array([0.0, 1e-20, 1e-20, 1e-12, 0.0, 2.7, 2.7, 1e-3],
                   np.float32)
    u = np.array([0.0, 0.0, 1e12, 1e9, 1e12, 0.0, -1e8, 0.0], np.float32)
    p = te.tillotson_pressure(torch.from_numpy(rho), torch.from_numpy(u),
                              material)
    c = te.tillotson_sound_speed(torch.from_numpy(rho), torch.from_numpy(u),
                                 material)
    assert bool(torch.isfinite(p).all()) and bool(torch.isfinite(c).all())
    assert float(c.min()) > 0.0
    p_ref = np.asarray(je.tillotson_pressure(jnp.asarray(rho),
                                             jnp.asarray(u), material))
    c_ref = np.asarray(je.tillotson_sound_speed(jnp.asarray(rho),
                                                jnp.asarray(u), material))
    a_scale = je.TILLOTSON_MATERIALS[material][3]
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-5,
                               atol=1e-6 * a_scale)
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-4)


@pytest.mark.parametrize("mode", ["polytropic", "adiabatic", "tillotson"])
def test_cfg_forms_match_jax(mode):
    kw = dict(eos_mode=mode, eos_gamma=5.0 / 3.0 if mode == "adiabatic"
              else 2.0, material="granite")
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    rho, u = _grid("granite")
    if mode != "tillotson":
        rho, u = rho * 1e-2, u * 1e-10
    mid = (np.arange(len(rho)) % 5).astype(np.int32)
    for matid in (None, mid) if mode == "tillotson" else (None,):
        jkw = dict(u=jnp.asarray(u),
                   matid=None if matid is None else jnp.asarray(matid))
        tkw = dict(u=torch.from_numpy(u),
                   matid=None if matid is None else torch.from_numpy(matid))
        p_ref = np.asarray(je.pressure_cfg(jnp.asarray(rho), jcfg, **jkw))
        p_out = te.pressure_cfg(torch.from_numpy(rho), tcfg, **tkw).numpy()
        np.testing.assert_allclose(p_out, p_ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(p_ref).max())
        c_ref = np.asarray(je.sound_speed_cfg(jnp.asarray(rho), jcfg, **jkw))
        c_out = te.sound_speed_cfg(torch.from_numpy(rho), tcfg,
                                   **tkw).numpy()
        np.testing.assert_allclose(c_out, c_ref, rtol=1e-4)


@pytest.mark.parametrize("mode", ["adiabatic", "tillotson"])
def test_evolved_u_eos_needs_u(mode):
    cfg = tc.SimConfig(eos_mode=mode)
    rho = torch.ones(4)
    with pytest.raises(ValueError, match="needs the internal energy u"):
        te.pressure_cfg(rho, cfg)
    with pytest.raises(ValueError, match="needs the internal energy u"):
        te.sound_speed_cfg(rho, cfg)
    # the polytropic forms ignore u
    poly = tc.SimConfig()
    assert torch.equal(te.pressure_cfg(rho, poly),
                       te.pressure_cfg(rho, poly, u=rho * 7))


def test_adiabatic_clamps_a_negative_energy_debt():
    cfg = tc.SimConfig(eos_mode="adiabatic", eos_gamma=1.4)
    rho = torch.tensor([1.0, 2.0, 3.0])
    u = torch.tensor([-0.5, 0.0, 2.0])
    p = te.pressure_cfg(rho, cfg, u=u)
    c = te.sound_speed_cfg(rho, cfg, u=u)
    np.testing.assert_allclose(p.numpy(), [0.0, 0.0, 0.4 * 3.0 * 2.0],
                               rtol=1e-6)
    np.testing.assert_allclose(c.numpy(), [0.0, 0.0, np.sqrt(1.4 * 0.4 * 2)],
                               rtol=1e-6)
