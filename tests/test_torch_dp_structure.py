"""The port's two-set build and sweeps (``src=``, the replicated
data-parallel layout) against its own single-set path and against the JAX
package's.

The production-stack configuration of tests/test_torch_structure.py at
n = 1024. First, ``src=`` set to the whole set must give what no ``src``
gives: windows, counts and overflow identical, force rows within rtol
1e-6. Then a split as a rank of four sees it: the targets are shard 2 of 4
(particles 512..767), the sources the whole set (target_offset 512), the
same numpy arrays through both packages. Windows, groupings and the far
mask must be identical; counts exact, rho rtol 1e-4, the rest within the
tolerances of tests/test_torch_structure.py (gradients rtol 1e-4 with an
atol of 1e-6 of the field's scale, phi rtol 3e-5), the h-solve rtol 1e-5
(cbrt against pow(., 1/3)). Outside a mesh, the all-gather that forces
takes for pass 2's source coefficients is a stand-in both packages get
alike: the shard's field repeated over the four shards' rows.
"""

import jax
import jax.numpy as jnp
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
# the symmetric pressure form with viscosity and the Balsara sums, the
# near gravity swept on its own
AV = dict(grad_p_mode="symmetric", h_mode="relax", av_alpha=1.0,
          av_beta=2.0, av_balsara=True, fuse_p2p_sph=False,
          fuse_p2p_residual=False)
SHARDS, RANK = 4, 2
T = lambda a: torch.from_numpy(np.array(a))
COUNTS = ("n_neighbors", "n_direct", "n_approx")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the exact counts here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed=5, n=1024):
    rng = np.random.default_rng(seed)
    pos = (8.0 * rng.normal(size=(n, 3))).astype(np.float32)
    h = (1.0 + rng.uniform(size=n)).astype(np.float32)
    mass = np.full(n, 0.05, np.float32)
    mass[::97] = 0.0                       # a few massless particles
    skin = rng.uniform(0.0, 0.2, n).astype(np.float32)
    vel = (0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    fbal = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return pos, h, mass, skin, vel, fbal


CLOUD = _cloud()
NL = KW["n"] // SHARDS
OFF = RANK * NL
LOC = slice(OFF, OFF + NL)


def _close(a, b, rtol, scale_atol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=scale_atol * np.abs(b).max())


def _tile_gather(x):
    return x.repeat(SHARDS)


def _jtile_gather(x):
    return jnp.tile(x, SHARDS)


def _equal_structures(a, b):
    for grp in ("groups", "src_groups"):
        for name in ("tgt_idx", "live", "unsort_idx"):
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(a, grp), name)),
                np.asarray(getattr(getattr(b, grp), name)),
                err_msg=f"{grp}.{name}")
    for name in ("sph_idx", "n_sph", "p2p_idx", "n_p2p", "m2p_idx", "n_m2p",
                 "accept", "sph_overflow", "p2p_overflow", "m2p_overflow",
                 "blk_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)


def test_src_the_whole_set_is_the_single_set():
    pos, h, mass, skin, _, _ = CLOUD
    cfg = tc.SimConfig(**KW)
    p, hh, m, sk = T(pos), T(h), T(mass), T(skin)
    one = ts.build(p, hh, m, cfg, skin=sk, h_margin=0.04)
    two = ts.build(p, hh, m, cfg, skin=sk, src=(p, hh, m), skin_src=sk,
                   h_margin=0.04)
    _equal_structures(two, one)
    assert two.src_groups is not two.groups and one.src_groups is one.groups
    f1 = ts.forces(p, hh, m, cfg, one)
    f2 = ts.forces(p, hh, m, cfg, two, src=(p, hh, m),
                   gather_fn=lambda x: x)
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(f2, name).numpy(),
                                      getattr(f1, name).numpy())
    for name in ("rho", "pressure", "grad_p", "phi", "grad_phi"):
        _close(getattr(f2, name), getattr(f1, name), 1e-6)
    # the whole-set h-solve too
    h1 = ts.solve_h_newton(p, hh, m, cfg, 0.55)
    h2 = ts.solve_h_newton(p, hh, m, cfg, 0.55, src=(p, hh, m))
    _close(h2, h1, 1e-6)


@pytest.fixture(scope="module")
def split():
    """Shard RANK's structure over the whole set, in both packages."""
    pos, h, mass, skin, _, _ = CLOUD
    jcfg, tcfg = jc.SimConfig(**KW), tc.SimConfig(**KW)
    src = (pos, h, mass)
    jst = jax.jit(lambda p, hh, m, sk, s, ss: js.build(
        p, hh, m, jcfg, skin=sk, src=s, target_offset=OFF, skin_src=ss,
        h_margin=0.04))(pos[LOC], h[LOC], mass[LOC], skin[LOC], src, skin)
    tst = ts.build(T(pos[LOC]), T(h[LOC]), T(mass[LOC]), tcfg,
                   skin=T(skin[LOC]), src=tuple(T(a) for a in src),
                   target_offset=OFF, skin_src=T(skin), h_margin=0.04)
    return jst, tst


def test_split_build_matches_jax(split):
    jst, tst = split
    _equal_structures(tst, jst)
    g, nb = tst.groups.live.shape[0], tst.src_groups.live.shape[0]
    assert g < nb and tst.accept.shape[0] == g
    # every tier is populated, so the comparison is not vacuous
    assert int(tst.n_sph.sum()) and int(tst.n_p2p.sum()) \
        and int(tst.n_m2p.sum()) and float(tst.accept.sum())


@pytest.mark.parametrize("form", ["production", "symmetric_av"])
def test_split_forces_match_jax(form):
    pos, h, mass, skin, vel, fbal = CLOUD
    kw = dict(KW, **(AV if form == "symmetric_av" else {}))
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    av = form == "symmetric_av"
    src = (pos, h, mass) + ((vel,) if av else ())
    loc = (pos[LOC], h[LOC], mass[LOC])
    vkw = dict(vel=vel[LOC], fbal=fbal[LOC]) if av else {}

    def jrun(p, hh, m, s, sk, ss, v):
        st = js.build(p, hh, m, jcfg, skin=sk, src=s[:3],
                      target_offset=OFF, skin_src=ss)
        return js.forces(p, hh, m, jcfg, st, src=s, target_offset=OFF,
                         gather_fn=_jtile_gather, **v)
    ref = jax.jit(jrun)(*loc, src, skin[LOC], skin, vkw)
    tsrc = tuple(T(a) for a in src)
    tst = ts.build(*(T(a) for a in loc), tcfg, skin=T(skin[LOC]),
                   src=tsrc[:3], target_offset=OFF, skin_src=T(skin))
    out = ts.forces(*(T(a) for a in loc), tcfg, tst, src=tsrc,
                    target_offset=OFF, gather_fn=_tile_gather,
                    **{k: T(v) for k, v in vkw.items()})
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    _close(out.rho, ref.rho, 1e-4)
    _close(out.grad_p, ref.grad_p, 1e-4, 1e-6)
    _close(out.phi, ref.phi, 3e-5)
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)
    if av:
        _close(out.balsara, ref.balsara, 1e-4, 1e-6)
    assert int(out.n_approx.sum()) > 0


def test_split_gravity_far_matches_jax(split):
    jst, tst = split
    pos, h, mass, _, _, _ = CLOUD
    jcfg, tcfg = jc.SimConfig(**KW), tc.SimConfig(**KW)
    src = (pos, h, mass)
    ref = jax.jit(lambda p, hh, m, st, s: js.gravity_far(
        p, hh, m, jcfg, st, src=s, target_offset=OFF))(
        pos[LOC], h[LOC], mass[LOC], jst, src)
    out = ts.gravity_far(T(pos[LOC]), T(h[LOC]), T(mass[LOC]), tcfg, tst,
                         src=tuple(T(a) for a in src), target_offset=OFF)
    _close(out[0], ref[0], 3e-5)
    _close(out[1], ref[1], 1e-4, 1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert int(out[2].sum()) > 0


def test_split_solve_h_newton_matches_jax():
    pos, h, mass, _, _, _ = CLOUD
    jcfg, tcfg = jc.SimConfig(**KW), tc.SimConfig(**KW)
    src = (pos, h, mass)
    rho0 = np.full(NL, 0.004, np.float32)
    solve = jax.jit(lambda p, hh, m, s, r0: js.solve_h_newton(
        p, hh, m, jcfg, 0.55, src=s, target_offset=OFF, rho0=r0))
    for r0 in (None, rho0):
        ref = solve(pos[LOC], h[LOC], mass[LOC], src, r0)
        out = ts.solve_h_newton(T(pos[LOC]), T(h[LOC]), T(mass[LOC]), tcfg,
                                0.55, src=tuple(T(a) for a in src),
                                target_offset=OFF,
                                rho0=None if r0 is None else T(r0))
        # cbrt (JAX) against pow(., 1/3) (PyTorch): an ulp per iteration
        _close(out, ref, 1e-5)


def test_groups_must_match_the_sets():
    pos, h, mass, _, _, _ = CLOUD
    cfg = tc.SimConfig(**KW)
    p, hh, m = T(pos), T(h), T(mass)
    one = ts.build(p, hh, m, cfg)
    with pytest.raises(ValueError, match="groups pair"):
        ts.build(p, hh, m, cfg, src=(p, hh, m), groups=one.groups)
    with pytest.raises(ValueError, match="one Groups"):
        ts.build(p, hh, m, cfg, groups=(one.groups, one.groups))
    # a frozen pair is reused as it is
    two = ts.build(p[LOC], hh[LOC], m[LOC], cfg, src=(p, hh, m),
                   target_offset=OFF)
    again = ts.build(p[LOC], hh[LOC], m[LOC], cfg, src=(p, hh, m),
                     target_offset=OFF,
                     groups=(two.groups, two.src_groups))
    _equal_structures(again, two)
