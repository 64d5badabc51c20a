"""The port's block structure and force evaluation in every configuration
of the grid + tree pipeline, against the JAX package's on the same numpy
cloud: fused, unfused and no-gravity builds; the three pressure forms, the
sign bug, viscosity and the Balsara limiter; near gravity fused into pass 2,
merged with the residual window, or swept on its own in one launch, near
only or far only; both softenings; the standalone gravity sweep of
dense-SPH runs, also against direct summation.

Window indices, counts, the acceptance mask and overflow must be IDENTICAL;
n_neighbors, n_direct and n_approx EQUAL; floats within the tolerances of
tests/test_structure.py (rho rtol 2e-6; gradients rtol 1e-4 with an atol of
1e-6 of the field's scale; phi rtol 3e-5).
"""

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.ops import structure as js
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import dense as td
from planetmodel_sph_tpu_torch.ops import structure as ts
from test_torch_structure import _cloud

BASE = dict(n=1024, radius=30.0, particle_radius=3.0, neighbor_mode="grid",
            gravity_solver="tree", nbr_group_size=32, nbr_sub=16,
            nbr_group_level=2, nbr_window=192, p2p_window=256,
            m2p_window=192)
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the tight tolerances here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    d = dict(BASE, **kw)
    return jc.SimConfig(**d), tc.SimConfig(**d)


def _close(a, b, rtol, scale_atol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=scale_atol * np.abs(b).max())


def _builds(jcfg, tcfg, seed=0, skin=True):
    pos, h, mass, sk = _cloud(seed)
    if not skin:
        sk = np.zeros_like(sk)
    jst = jax.jit(lambda p, hh, m, s: js.build(p, hh, m, jcfg, skin=s))(
        pos, h, mass, sk)
    tst = ts.build(T(pos), T(h), T(mass), tcfg, skin=T(sk))
    return (pos, h, mass), jst, tst


BUILD_FIELDS = ("sph_idx", "n_sph", "p2p_idx", "n_p2p", "m2p_idx", "n_m2p",
                "accept", "sph_overflow", "p2p_overflow", "m2p_overflow")


@pytest.mark.parametrize("kw", [
    dict(), dict(fuse_p2p_sph=True),
    dict(fuse_p2p_sph=True, fuse_p2p_residual=True,
         sph_refine_subblock=True),
    dict(gravity_solver="none"),
    dict(neighbor_mode="dense"),
], ids=["unfused", "fused", "merged+refine", "no_gravity", "dense_sph"])
def test_build_identical(kw):
    jcfg, tcfg = _cfgs(**kw)
    _, jst, tst = _builds(jcfg, tcfg)
    for name in BUILD_FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    assert int(tst.n_sph.sum()) > 0
    if kw.get("gravity_solver") == "none":
        # no gravity partition at all
        assert int(tst.n_p2p.sum()) == 0 == int(tst.n_m2p.sum())
        assert float(tst.accept.sum()) == 0.0
        assert bool((tst.p2p_idx == -1).all())
    else:
        assert int(tst.n_p2p.sum()) and int(tst.n_m2p.sum()) \
            and float(tst.accept.sum())


def test_unfused_build_keeps_sph_subblocks_in_the_tiers():
    """Only the fusion takes the SPH-window sub-blocks out of the gravity
    tiers: an unfused build's P2P window holds them, a fused one's does
    not, and each partitions the live sub-blocks exactly once."""
    _, tcfg = _cfgs()
    _, tfused = _cfgs(fuse_p2p_sph=True)
    pos, h, mass, sk = _cloud(2)
    args = (T(pos), T(h), T(mass))
    un = ts.build(*args, tcfg, skin=T(sk))
    fu = ts.build(*args, tfused, skin=T(sk))
    assert int(un.n_p2p.sum()) > int(fu.n_p2p.sum())
    g = un.groups.live.shape[0]
    spb = tcfg.nbr_group_size // tcfg.nbr_sub
    live_sub = un.groups.live.reshape(g * spb, tcfg.nbr_sub).any(dim=1)
    for st, fused in ((un, False), (fu, True)):
        cover = st.accept[:, :g].repeat_interleave(spb, dim=1) > 0.5
        cover = (cover & live_sub[None, :]).int()
        for idx in (st.p2p_idx, st.m2p_idx) + ((st.sph_idx,) if fused
                                               else ()):
            hit = torch.zeros_like(cover)
            hit.scatter_reduce_(1, idx.clamp(min=0).long(),
                                (idx >= 0).int(), reduce="amax")
            cover = cover + hit
        tvalid = st.groups.live.any(dim=1)
        want = live_sub[None, :].int().expand(g, -1)
        assert torch.equal(cover[tvalid], want[tvalid])


FORCE_CASES = {
    "symmetric": dict(grad_p_mode="symmetric"),
    "asymmetric+sign_bug+receiver": dict(
        grad_p_mode="reference_asymmetric", kernel_deriv_sign_bug=True,
        softening_mode="receiver_h"),
    "symmetric+av": dict(grad_p_mode="symmetric", av_alpha=1.0,
                         av_beta=2.0),
    "grad_h+av+balsara": dict(grad_p_mode="grad_h", av_alpha=0.5,
                              av_beta=1.0, av_balsara=True,
                              multipole_order=2),
    "asymmetric+sign_bug+av+balsara": dict(
        grad_p_mode="reference_asymmetric", kernel_deriv_sign_bug=True,
        av_alpha=1.0, av_beta=2.0, av_balsara=True),
    "symmetric+fused": dict(grad_p_mode="symmetric", fuse_p2p_sph=True),
    "grad_h+fused+receiver": dict(grad_p_mode="grad_h", fuse_p2p_sph=True,
                                  softening_mode="receiver_h"),
    "symmetric+merged+receiver+av": dict(
        grad_p_mode="symmetric", fuse_p2p_sph=True, fuse_p2p_residual=True,
        softening_mode="receiver_h", av_alpha=1.0, av_beta=2.0),
    "symmetric+no_gravity": dict(grad_p_mode="symmetric",
                                 gravity_solver="none"),
    "grad_h+theta0+fused": dict(grad_p_mode="grad_h", fuse_p2p_sph=True,
                                theta=1e-6, p2p_window=256),
}


def _forces_pair(kw, seed=0, **fkw):
    jcfg, tcfg = _cfgs(**kw)
    (pos, h, mass), jst, tst = _builds(jcfg, tcfg, seed)
    rng = np.random.default_rng(seed + 7)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    fbal = rng.uniform(0.0, 1.0, h.shape).astype(np.float32)
    balsara = jcfg.av_balsara and jcfg.av_alpha > 0
    ref = jax.jit(lambda p, hh, m, v, f, st: js.forces(
        p, hh, m, jcfg, st, vel=v, fbal=f if balsara else None, **fkw))(
        pos, h, mass, vel, fbal, jst)
    out = ts.forces(T(pos), T(h), T(mass), tcfg, tst, vel=T(vel),
                    fbal=T(fbal) if balsara else None, **fkw)
    return ref, out, tcfg


def _check_forces(ref, out, gravity=True):
    _close(out.rho, ref.rho, 2e-6)
    _close(out.pressure, ref.pressure, 5e-6)
    _close(out.grad_p, ref.grad_p, 1e-4, 1e-6)
    for name in ("n_neighbors", "n_direct", "n_approx"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    if gravity:
        _close(out.phi, ref.phi, 3e-5)
        _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)
        assert int(out.n_direct.sum()) > 0
    if ref.balsara is None:
        assert out.balsara is None
    else:
        _close(out.balsara, ref.balsara, 1e-4, 1e-6)
        assert float(out.balsara.min()) < float(out.balsara.max()) <= 1.0


@pytest.mark.parametrize("case", sorted(FORCE_CASES))
def test_forces_match_jax(case):
    kw = FORCE_CASES[case]
    ref, out, tcfg = _forces_pair(kw)
    gravity = tcfg.gravity_solver == "tree"
    _check_forces(ref, out, gravity)
    if not gravity:
        # gravity_solver='none' on grid neighbours: zero fields and counts
        for name in ("phi", "grad_phi", "n_direct", "n_approx"):
            assert float(getattr(out, name).abs().sum()) == 0.0, name
    elif kw.get("theta", 1.0) < 1e-3:
        assert int(out.n_approx.max()) <= 2
    else:
        assert int(out.n_approx.sum()) > 0


@pytest.mark.parametrize("tiers", ["near", "far"])
@pytest.mark.parametrize("case", ["symmetric", "symmetric+fused",
                                  "symmetric+merged+receiver+av"])
def test_forces_near_and_far_tiers_match_jax(case, tiers):
    ref, out, _ = _forces_pair(FORCE_CASES[case], seed=1, grav_tiers=tiers)
    _close(out.phi, ref.phi, 3e-5)
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)
    for name in ("n_direct", "n_approx"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    if case == "symmetric":
        # the unfused tiers alone: near has no multipole entry, far no
        # direct pair
        assert int(out.n_approx.sum() if tiers == "near"
                   else out.n_direct.sum()) == 0


def test_n_direct_bookkeeping_of_the_three_assemblies():
    """Merged, fused-unmerged and unfused count the same direct pairs: the
    same near sub-blocks, swept in one, two or one launch(es)."""
    nd = {}
    for name, kw in (("unfused", {}), ("fused", dict(fuse_p2p_sph=True)),
                     ("merged", dict(fuse_p2p_sph=True,
                                     fuse_p2p_residual=True))):
        _, out, _ = _forces_pair(dict(grad_p_mode="symmetric", theta=1e-6,
                                      p2p_window=256, **kw))
        nd[name] = out.n_direct + out.n_approx
    live = int((T(_cloud(0)[2]) > 0).sum())
    # theta -> 0: every live particle but oneself, directly (or, for a
    # sub-block of one live particle, as its exact monopole)
    assert torch.equal(nd["unfused"], torch.full_like(nd["unfused"],
                                                      live - 1))
    assert torch.equal(nd["fused"], nd["unfused"])
    assert torch.equal(nd["merged"], nd["unfused"])


@pytest.mark.parametrize("soft", ["receiver_h", "symmetric_max"])
def test_port_fused_p2p_is_exact_when_theta_zero(soft):
    """theta -> 0: everything is near-field, split between the fused pass-2
    rows and the remainder P2P window; the union equals direct summation
    (the bound of the reference's test of the same name)."""
    kw = dict(theta=1e-6, p2p_window=256, softening_mode=soft,
              fuse_p2p_sph=True, grad_p_mode="grad_h")
    _, out, tcfg = _forces_pair(kw)
    pos, h, mass, _ = _cloud(0)
    p1 = td.pass1(T(pos), T(h), T(mass), tcfg.replace(
        neighbor_mode="dense", gravity_solver="direct",
        grad_p_mode="symmetric"))
    np.testing.assert_allclose(out.phi.numpy(), p1.phi.numpy(), rtol=3e-5,
                               atol=1e-7)
    np.testing.assert_allclose(out.grad_phi.numpy(), p1.grad_phi.numpy(),
                               rtol=3e-4, atol=3e-5)
    live = torch.from_numpy(mass > 0)
    assert torch.equal(out.n_direct[live], p1.n_direct[live])


def test_fused_residual_matches_separate_launch():
    """The merged launch sweeps the same residual window with the same
    math as the separate gravity launch (the reference's test of the same
    name, its tolerances)."""
    for soft in ("receiver_h", "symmetric_max"):
        _, tcfg = _cfgs(fuse_p2p_sph=True, softening_mode=soft,
                        grad_p_mode="grad_h")
        pos, h, mass, _ = _cloud(3)
        args = (T(pos), T(h), T(mass))
        st = ts.build(*args, tcfg)
        ref = ts.forces(*args, tcfg, st)
        out = ts.forces(*args, tcfg.replace(fuse_p2p_residual=True), st)
        np.testing.assert_allclose(out.phi, ref.phi, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out.grad_phi, ref.grad_phi, rtol=2e-5,
                                   atol=2e-5)
        assert torch.equal(out.n_direct, ref.n_direct)
        np.testing.assert_allclose(out.grad_p, ref.grad_p, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(softening_mode="receiver_h"),
    dict(multipole_order=2, theta=0.9),
    dict(neighbor_mode="dense", softening_mode="receiver_h",
         grad_p_mode="reference_asymmetric"),
], ids=["receiver_h", "quadrupole", "parity_like_dense_cfg"])
def test_gravity_matches_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    (pos, h, mass), jst, tst = _builds(jcfg, tcfg, seed=4, skin=False)
    ref = jax.jit(lambda p, hh, m, st: js.gravity(p, hh, m, jcfg, st))(
        pos, h, mass, jst)
    out = ts.gravity(T(pos), T(h), T(mass), tcfg, tst)
    _close(out[0], ref[0], 3e-5)
    _close(out[1], ref[1], 1e-4, 1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert int(out[2].sum()) > 0 and int(out[3].sum()) > 0


def test_gravity_exact_when_theta_zero_and_close_to_direct():
    pos, h, mass, _ = _cloud(5)
    args = (T(pos), T(h), T(mass))
    _, tcfg = _cfgs(theta=1e-6, p2p_window=256)
    st = ts.build(*args, tcfg)
    assert int(st.p2p_overflow) == 0
    phi, gphi, nd, na = ts.gravity(*args, tcfg, st)
    p1 = td.pass1(*args, tcfg.replace(neighbor_mode="dense",
                                      gravity_solver="direct"))
    np.testing.assert_allclose(phi, p1.phi, rtol=3e-5, atol=1e-7)
    np.testing.assert_allclose(gphi, p1.grad_phi, rtol=3e-4, atol=3e-5)
    # only a sub-block of one live particle (bmax = 0, an exact monopole)
    # can pass the MAC at theta -> 0
    assert int(na.max()) <= 2 and int(nd.min()) >= int((mass > 0).sum()) - 3
    # theta = 0.7: the multipole tiers carry work, with a small MAC error
    _, tcfg = _cfgs(theta=0.7, softening_mode="receiver_h")
    st = ts.build(*args, tcfg)
    phi, gphi, nd, na = ts.gravity(*args, tcfg, st)
    p1 = td.pass1(*args, tcfg.replace(neighbor_mode="dense",
                                      gravity_solver="direct"))
    assert int(na.sum()) > 0
    err = float((gphi - p1.grad_phi).abs().max() / p1.grad_phi.abs().max())
    assert err < 0.02, err
    perr = float((phi - p1.phi).abs().max() / p1.phi.abs().max())
    assert perr < 0.02, perr


def test_fuse_guards():
    """fuse_active as the reference's: the residual merge needs the fusion,
    the fusion needs grid neighbours; a dense-SPH config with tree gravity
    builds unfused without complaint."""
    pos, h, mass, _ = _cloud()
    with pytest.raises(ValueError, match="fuse_p2p_residual"):
        ts.fuse_active(tc.SimConfig(**dict(BASE, fuse_p2p_residual=True)))
    with pytest.raises(ValueError, match="fuse_p2p_sph"):
        ts.build(T(pos), T(h), T(mass), tc.SimConfig(
            **dict(BASE, neighbor_mode="dense", fuse_p2p_sph=True)))
    assert ts.fuse_active(tc.parity()) is False
    assert ts.fuse_active(tc.jupiter_100k()) is True


def test_viscosity_needs_velocities():
    _, tcfg = _cfgs(av_alpha=1.0)
    pos, h, mass, _ = _cloud()
    args = (T(pos), T(h), T(mass))
    with pytest.raises(ValueError, match="vel"):
        ts.forces(*args, tcfg, ts.build(*args, tcfg))


# ---------------------------------------------------------------------------
# the supergroup far tier (cfg.sg_blocks > 1)
# ---------------------------------------------------------------------------

SG_BUILD_FIELDS = BUILD_FIELDS + ("blk_idx", "n_blk", "blk_overflow")
# (config overrides, cloud seed, cloud size): the second gives a block
# count that 4 does not divide, the third drops entries of a narrow window
SG_CASES = {
    "sg4": (dict(sg_blocks=4, blk_window=64), 0, 1024),
    "sg4_ragged": (dict(sg_blocks=4, blk_window=64), 6, 960),
    "sg4_overflow": (dict(sg_blocks=4, blk_window=4), 0, 1024),
    "sg3_quadrupole": (dict(sg_blocks=3, blk_window=64, multipole_order=2,
                            theta=0.9), 2, 1024),
}


def _sg_builds(case):
    kw, seed, n = SG_CASES[case]
    jcfg, tcfg = _cfgs(**dict(dict(n=n, theta=1.0), **kw))
    pos, h, mass, sk = _cloud(seed, n)
    jst = jax.jit(lambda p, hh, m, s: js.build(p, hh, m, jcfg, skin=s))(
        pos, h, mass, sk)
    tst = ts.build(T(pos), T(h), T(mass), tcfg, skin=T(sk))
    return (pos, h, mass), jcfg, tcfg, jst, tst


@pytest.mark.parametrize("case", sorted(SG_CASES))
def test_supergroup_build_identical(case):
    _, _, tcfg, jst, tst = _sg_builds(case)
    for name in SG_BUILD_FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    nb = tst.groups.live.shape[0]
    nsg = -(-nb // tcfg.sg_blocks)
    assert tst.accept.shape[1] == -(-nsg // tcfg.block_chunk) \
        * tcfg.block_chunk
    assert int(tst.n_blk.sum()) > 0 and float(tst.accept.sum()) > 0
    if case == "sg4_ragged":
        assert nb % tcfg.sg_blocks != 0
    assert (int(tst.blk_overflow) > 0) == (case == "sg4_overflow")
    info = ts.overflow_info(tst)
    assert int(info["tree_overflow"]) == int(
        tst.p2p_overflow + tst.m2p_overflow + tst.blk_overflow)


def test_supergroup_partition_covers_each_block_once():
    """With the tier on, a block is covered by its supergroup or by a blk
    entry, never both; what neither covers is left to the sub-block tiers
    exactly once."""
    _, _, tcfg, _, st = _sg_builds("sg4_ragged")
    g = nb = st.groups.live.shape[0]
    sgf = tcfg.sg_blocks
    spb = tcfg.nbr_group_size // tcfg.nbr_sub
    nsg = -(-nb // sgf)
    sg_cover = (st.accept[:, :nsg] > 0.5).repeat_interleave(sgf, dim=1)[
        :, :nb]
    blk = torch.zeros((g, nb), dtype=torch.int32)
    blk.scatter_reduce_(1, st.blk_idx.clamp(min=0).long(),
                        (st.blk_idx >= 0).int(), reduce="amax")
    assert not bool((sg_cover & (blk > 0)).any())
    bvalid = st.groups.live.any(dim=1)
    cover = ((sg_cover & bvalid[None, :]).int() + blk).repeat_interleave(
        spb, dim=1)
    live_sub = st.groups.live.reshape(nb * spb, tcfg.nbr_sub).any(dim=1)
    cover = cover * live_sub[None, :].int()
    for idx in (st.p2p_idx, st.m2p_idx):
        hit = torch.zeros_like(cover)
        hit.scatter_reduce_(1, idx.clamp(min=0).long(), (idx >= 0).int(),
                            reduce="amax")
        cover = cover + hit
    want = live_sub[None, :].int().expand(g, -1)
    assert torch.equal(cover[bvalid], want[bvalid])


@pytest.mark.parametrize("tiers", ["all", "far"])
@pytest.mark.parametrize("case", ["sg4", "sg4_ragged", "sg3_quadrupole"])
def test_supergroup_forces_match_jax(case, tiers):
    (pos, h, mass), jcfg, tcfg, jst, tst = _sg_builds(case)
    ref = jax.jit(lambda p, hh, m, st: js.forces(
        p, hh, m, jcfg, st, grav_tiers=tiers))(pos, h, mass, jst)
    out = ts.forces(T(pos), T(h), T(mass), tcfg, tst, grav_tiers=tiers)
    _close(out.phi, ref.phi, 3e-5)
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)
    for name in ("n_direct", "n_approx"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # the supergroups take work off the block scan: fewer multipole
    # entries than the same cloud without the tier, the blk tier counted
    base = ts.forces(T(pos), T(h), T(mass), tcfg.replace(sg_blocks=0),
                     ts.build(T(pos), T(h), T(mass),
                              tcfg.replace(sg_blocks=0)), grav_tiers=tiers)
    assert 0 < int(out.n_approx.sum()) < int(base.n_approx.sum())


def test_supergroup_standalone_gravity_matches_jax():
    (pos, h, mass), jcfg, tcfg, jst, tst = _sg_builds("sg4")
    ref = jax.jit(lambda p, hh, m, st: js.gravity(p, hh, m, jcfg, st))(
        pos, h, mass, jst)
    out = ts.gravity(T(pos), T(h), T(mass), tcfg, tst)
    _close(out[0], ref[0], 3e-5)
    _close(out[1], ref[1], 1e-4, 1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))


def test_fusion_refuses_the_supergroup_tier():
    with pytest.raises(ValueError, match="no supergroup tier"):
        ts.fuse_active(tc.SimConfig(**dict(BASE, fuse_p2p_sph=True,
                                           sg_blocks=4)))


# ---------------------------------------------------------------------------
# the energy equation in forces (adiabatic and Tillotson EOS)
# ---------------------------------------------------------------------------

ENERGY_FORCE_CASES = {
    "adiabatic+grad_h": dict(eos_mode="adiabatic", grad_p_mode="grad_h"),
    "adiabatic+grad_h+av": dict(eos_mode="adiabatic", grad_p_mode="grad_h",
                                av_alpha=1.0, av_beta=2.0),
    "adiabatic+symmetric": dict(eos_mode="adiabatic",
                                grad_p_mode="symmetric"),
    "adiabatic+symmetric+av+balsara+merged": dict(
        eos_mode="adiabatic", grad_p_mode="symmetric", av_alpha=1.0,
        av_beta=2.0, av_balsara=True, fuse_p2p_sph=True,
        fuse_p2p_residual=True),
    "adiabatic+grad_h+sg4": dict(eos_mode="adiabatic", grad_p_mode="grad_h",
                                 sg_blocks=4, blk_window=64),
    "tillotson+symmetric+av": dict(eos_mode="tillotson", material="basalt",
                                   grad_p_mode="symmetric", av_alpha=1.0,
                                   av_beta=2.0, g_const=1e-3),
    "tillotson+grad_h+av+fused": dict(eos_mode="tillotson", material="ice",
                                      grad_p_mode="grad_h", av_alpha=1.0,
                                      av_beta=2.0, fuse_p2p_sph=True,
                                      g_const=1e-3),
}


def _energy_pair(kw, seed=0, sorted_io=False):
    jcfg, tcfg = _cfgs(**kw)
    (pos, h, mass), jst, tst = _builds(jcfg, tcfg, seed)
    rng = np.random.default_rng(seed + 11)
    vel = rng.normal(size=pos.shape).astype(np.float32)
    till = jcfg.eos_mode == "tillotson"
    # Tillotson: the cloud's densities are ~1e-3 of any rho0 (expanded
    # branches); u spans cold to vaporised, with some exactly 0
    u = (rng.uniform(0.0, 3e11 if till else 2.0, h.shape)
         .astype(np.float32))
    u[::13] = 0.0
    matid = rng.integers(0, 5, h.shape).astype(np.int32) if till else None
    ref = jax.jit(lambda p, hh, m, v, uu, st: js.forces(
        p, hh, m, jcfg, st, vel=v, u=uu, matid=matid))(
        pos, h, mass, vel, u, jst)
    out = ts.forces(T(pos), T(h), T(mass), tcfg, tst, vel=T(vel), u=T(u),
                    matid=T(matid) if till else None)
    return ref, out, tcfg


@pytest.mark.parametrize("case", sorted(ENERGY_FORCE_CASES))
def test_forces_energy_equation_matches_jax(case):
    """du_dt within the reference's own tolerance for the energy equation
    (rtol 1e-4, atol 1e-5 of the field's scale); the pressure now depends
    on u (and on the material)."""
    ref, out, tcfg = _energy_pair(ENERGY_FORCE_CASES[case])
    _close(out.rho, ref.rho, 2e-6)
    _close(out.pressure, ref.pressure, 1e-5, 1e-7)
    _close(out.grad_p, ref.grad_p, 1e-4, 1e-6)
    _close(out.du_dt, ref.du_dt, 1e-4, 1e-5)
    _close(out.phi, ref.phi, 3e-5)
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)
    for name in ("n_neighbors", "n_direct", "n_approx"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert float(out.du_dt.abs().max()) > 0.0
    assert bool(torch.isfinite(out.du_dt).all())
    if ref.balsara is not None:
        _close(out.balsara, ref.balsara, 1e-4, 1e-6)


def test_energy_equation_refusals_are_the_references():
    pos, h, mass, _ = _cloud()
    args = (T(pos), T(h), T(mass))
    _, tcfg = _cfgs(eos_mode="adiabatic")
    st = ts.build(*args, tcfg)
    with pytest.raises(ValueError, match="needs u and vel"):
        ts.forces(*args, tcfg, st, vel=T(pos))
    with pytest.raises(ValueError, match="needs u and vel"):
        ts.forces(*args, tcfg, st, u=T(h))
    _, asym = _cfgs(eos_mode="adiabatic",
                    grad_p_mode="reference_asymmetric")
    with pytest.raises(ValueError, match="momentum-conserving"):
        ts.forces(*args, asym, st, vel=T(pos), u=T(h))


def test_dead_groups_keep_the_energy_rate_finite():
    """A target group without live particles sits at the density floor; its
    pressure coefficient is zeroed, so du_dt is 0 there, not 0/0."""
    pos, h, mass, _ = _cloud(3)
    mass = mass.copy()
    _, tcfg = _cfgs(eos_mode="adiabatic", grad_p_mode="grad_h")
    st0 = ts.build(T(pos), T(h), T(mass), tcfg)
    dead = st0.groups.tgt_idx.reshape(-1, tcfg.nbr_group_size)[1].numpy()
    mass[dead] = 0.0
    args = (T(pos), T(h), T(mass))
    st = ts.build(*args, tcfg)
    out = ts.forces(*args, tcfg, st, vel=T(pos) * 0.1,
                    u=torch.ones(len(h)))
    for name in ("du_dt", "grad_p", "rho"):
        assert bool(torch.isfinite(getattr(out, name)).all()), name
