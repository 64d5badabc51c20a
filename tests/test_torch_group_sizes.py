"""Group sizes the windowed kernels once refused, against the JAX package.

The reference takes any ``nbr_group_size`` that ``nbr_sub`` divides
(``planetmodel_sph_tpu/ops/structure.py``). The port's kernels split a
group of more than 256 targets over blocks of 256 (``psph_share``,
``csrc/common.cuh``; ``filter_sph`` loops over words of 32 boxes) and give
``p2p`` an odd group's last target alone; ``config.check_slice`` admits
both. These tests run the port's structure and sweeps on the CPU (the
kernels' plain versions, which ``chip_smoke.py`` holds the kernels
against on the card at b = 512, 1024 and 33) against the JAX package's on
the same numpy cloud:

- b = 512 on the grid path, unfused, and in the production form (grad-h,
  near gravity and the residual-P2P window merged into pass 2, the
  windows refined through filter_sph);
- b = 33 with nbr_sub = 11 on the grid path's unfused near tier, whose
  RESPA inner force launches ``p2p``;
- ``filter_sph`` at b = FILTER_MAX_GROUP and one more, where the kernel
  cuts a group into tiles (``groups2.filter_tiles``).

Window indices, counts and overflow IDENTICAL; floats within the
tolerances of tests/test_structure.py (rho rtol 2e-6; gradients rtol 1e-4
with an atol of 1e-6 of the field's scale; phi rtol 3e-5).
"""

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.ops import structure as js
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import structure as ts
from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
from test_torch_gravity_tiers import BUILD_FIELDS, _check_forces, _close
from test_torch_structure import _cloud

BASE = dict(radius=30.0, particle_radius=3.0, neighbor_mode="grid",
            gravity_solver="tree", nbr_group_level=2)
# the windows hold each case's occupancies (overflow 0)
CASES = {
    "b512": dict(n=4096, nbr_group_size=512, nbr_sub=64, nbr_window=64,
                 p2p_window=80, m2p_window=16),
    "b512_grad_h_merged": dict(n=4096, nbr_group_size=512, nbr_sub=64,
                               nbr_window=64, p2p_window=80, m2p_window=16,
                               grad_p_mode="grad_h", fuse_p2p_sph=True,
                               fuse_p2p_residual=True,
                               sph_refine_subblock=True,
                               sph_refined_window=48),
    "b33_unfused_near_tier": dict(n=1024, nbr_group_size=33, nbr_sub=11,
                                  nbr_window=96, p2p_window=128,
                                  m2p_window=64, fuse_p2p_sph=False,
                                  fuse_p2p_residual=False, respa_every=2),
}
T = lambda a: torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the tight tolerances here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(case):
    kw = dict(BASE, **CASES[case])
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    tc.check_slice(tcfg)
    pos, h, mass, sk = _cloud(0, kw["n"])
    jst = jax.jit(lambda p, hh, m, s: js.build(p, hh, m, jcfg, skin=s))(
        pos, h, mass, sk)
    tst = ts.build(T(pos), T(h), T(mass), tcfg, skin=T(sk))
    return (pos, h, mass), (jcfg, jst), (tcfg, tst)


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_identical_at_admitted_group_sizes(case):
    _, (_, jst), (tcfg, tst) = _pair(case)
    assert tst.groups.live.shape[1] == tcfg.nbr_group_size
    for name in BUILD_FIELDS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    assert {k: int(v) for k, v in ts.overflow_info(tst).items()} == \
        {"nbr_overflow": 0, "tree_overflow": 0}
    assert int(tst.n_sph.sum()) and int(tst.n_p2p.sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forces_match_jax_at_admitted_group_sizes(case):
    (pos, h, mass), (jcfg, jst), (tcfg, tst) = _pair(case)
    ref = jax.jit(lambda p, hh, m, st: js.forces(p, hh, m, jcfg, st))(
        pos, h, mass, jst)
    out = ts.forces(T(pos), T(h), T(mass), tcfg, tst)
    _check_forces(ref, out)


def test_odd_group_near_tier_matches_jax_through_p2p(monkeypatch):
    """The RESPA inner force of the unfused grid + tree chunk at b = 33:
    the near tier alone, through the p2p wrapper."""
    (pos, h, mass), (jcfg, jst), (tcfg, tst) = _pair(
        "b33_unfused_near_tier")
    calls = []
    p2p = gk2.p2p
    monkeypatch.setattr(gk2, "p2p", lambda *a, **kw: calls.append(
        kw["b"]) or p2p(*a, **kw))
    ref = jax.jit(lambda p, hh, m, st: js.forces(
        p, hh, m, jcfg, st, grav_tiers="near"))(pos, h, mass, jst)
    out = ts.forces(T(pos), T(h), T(mass), tcfg, tst, grav_tiers="near")
    assert calls == [33]
    _close(out.phi, ref.phi, 3e-5)
    _close(out.grad_phi, ref.grad_phi, 1e-4, 1e-6)
    np.testing.assert_array_equal(out.n_direct.numpy(),
                                  np.asarray(ref.n_direct))
    assert int(out.n_direct.sum()) > 0 and int(out.n_approx.sum()) == 0


def _filter_box():
    import os
    import re
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "planetmodel_sph_tpu_torch", "csrc",
        "filter_sph.cu")).read()
    return int(re.search(r"#define\s+PSPH_FILTER_BOX\s+(\d+)", src).group(1))


def _filter_max_group():
    """The largest group filter_sph.cu holds in shared memory: b float4
    targets, 2 ceil(b / PSPH_FILTER_BOX) float4 boxes and b float skins
    within FILTER_MAX_DYNAMIC, as the source defines them."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "planetmodel_sph_tpu_torch", "csrc",
        "filter_sph.cu")).read()
    define = lambda k: re.search(rf"#define\s+{k}\s+(.+)", src).group(1)
    threads = int(define("FILTER_THREADS"))
    box = int(define("PSPH_FILTER_BOX"))
    limit = eval(define("FILTER_MAX_DYNAMIC").replace(
        "FILTER_THREADS", str(threads)))
    need = lambda b: (b + 2 * -(-b // box)) * 16 + 4 * b
    b = 1
    while need(b + 1) <= limit:
        b += 1
    return b


def _filter_inputs(b, g=2, s=96, seed=0):
    """Seeded filter_sph inputs for g groups of b targets in the unit cube
    (a fair share of the live slots kept), with NaNs planted in a target's
    x, tc and tsk of group 0 and in a slot's x and sc of the last group,
    and a dead slot (m = 0) there."""
    rng = np.random.default_rng(seed)
    tgt = [rng.random((g * b, 1), dtype=np.float32) for _ in range(3)]
    tgt += [np.full((g * b, 1), 0.025, np.float32),
            np.full((g * b, 1), 1e-3, np.float32)]
    src = [rng.random((g, s), dtype=np.float32) for _ in range(3)]
    src += [np.full((g, s), 0.025, np.float32),
            np.full((g, s), 1e-3, np.float32),
            rng.random((g, s), dtype=np.float32) + 0.5]
    nv = np.array([s - 16, s][:g], np.int32)
    tgt[0][7, 0] = np.nan
    tgt[3][b - 1, 0] = np.nan
    tgt[4][b // 2, 0] = np.nan
    src[0][g - 1, 5] = np.nan
    src[3][g - 1, 9] = np.nan
    src[5][g - 1, 11] = 0.0
    return nv, tgt, src


def test_filter_sph_refuses_a_group_past_its_shared_memory():
    """No longer refused: the wrapper takes a group past one block's
    shared memory (FILTER_MAX_GROUP, read from filter_sph.cu). On the CPU
    it returns its plain version before any tiling, so this holds that
    version at b = FILTER_MAX_GROUP and + 1 exactly against the JAX
    package's filter_sph (its jnp fallback), planted NaNs included; the
    tiled kernel itself is held against the plain version only on the
    card, by chip_smoke.py's filter@b9821 and filter@b16384 cases."""
    from planetmodel_sph_tpu.ops.pallas import groups2 as jk
    import jax.numpy as jnp
    assert gk2.FILTER_MAX_GROUP == _filter_max_group()
    for b in (gk2.FILTER_MAX_GROUP, gk2.FILTER_MAX_GROUP + 1):
        nv, tgt, src = _filter_inputs(b)
        ref = np.asarray(jk.filter_sph(jnp.asarray(nv),
                                       [jnp.asarray(x) for x in tgt],
                                       [jnp.asarray(r) for r in src], b=b,
                                       chunk=32))
        out = gk2.filter_sph(T(nv), [T(x) for x in tgt], [T(r) for r in src],
                             b=b)
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=str(b))
        kept = ref[:, :80].mean()
        assert 0.05 < kept < 0.95, kept
        assert not ref[1, 11] and not ref[:, 80:][0].any()


@pytest.mark.parametrize("b", [9821, 16384, 19641, 29461])
def test_filter_tiles_cover_the_group_within_one_block(b):
    """The tiled path's tiles: as few as fit one block's shared memory, or
    more to give 8 groups 264 blocks (two an H100 multiprocessor, as the
    wrapper asks), each at most FILTER_MAX_GROUP targets and whole boxes
    of PSPH_FILTER_BOX, together exactly the group; the OR of the tiles'
    plain masks is the whole group's."""
    assert gk2.FILTER_BOX == _filter_box()
    fewest = -(-b // gk2.FILTER_MAX_GROUP)
    nv, tgt, src = _filter_inputs(b, g=1, s=64, seed=b)
    whole = gk2.filter_sph_plain(T(nv), [T(x) for x in tgt],
                                 [T(r) for r in src])
    for g, blocks in ((1, 1), (8, 264)):
        tiles, tile = gk2.filter_tiles(b, g, blocks)
        assert tile <= gk2.FILTER_MAX_GROUP == _filter_max_group()
        assert (tiles - 1) * tile < b <= tiles * tile
        assert tile % gk2.FILTER_BOX == 0
        if blocks == 1:
            assert tiles == fewest
        else:
            # the even split for 33 tiles, up to a whole box
            assert tiles > fewest and tile < -(-b // 33) + gk2.FILTER_BOX
        parts = [gk2.filter_sph_plain(
            T(nv), [T(x[t * tile:(t + 1) * tile]) for x in tgt],
            [T(r) for r in src]) for t in range(tiles)]
        np.testing.assert_array_equal(
            torch.stack(parts).amax(dim=0).numpy(), whole.numpy())
