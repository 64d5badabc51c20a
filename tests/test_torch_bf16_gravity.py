"""The bfloat16 gravity pair path (``grav_pair_dtype="bfloat16"``) of the
port against the JAX package's bf16 branch.

The port's plain versions of ``p2p`` and ``gravity_fused`` with
``bf16=True`` are held against the JAX package's sweeps, which on the CPU
run a bf16 call through the Pallas bodies in interpret mode (it never
takes ``fallback.py``), on the inputs of tests/test_torch_groups2.py
(ragged nv with a group below S, m = 0 slots, self pairs, both sides of
the Dyer-Ip x = 1 edge): phi within 1e-5 relative, g within 1e-5 of
max|g|, counts exact. Then the slice as a whole: ``structure.gravity`` on
the reference test's cloud (``tests/test_structure.py``'s ``_cfg``, n =
512), 4 cached RESPA steps of a small unfused grid configuration and 4
steps of the ``parity`` preset, both at n = 384: phi within 5e-5 and grad
phi within 2.5e-4 of the field's largest magnitude (after priming and
after the steps), accel within 2e-5 and vel within 1e-5 after the steps,
pos within 1e-6, counts exact. The slice's tolerance is wider than the
kernels' because XLA's CPU rsqrt is not PyTorch's 1/sqrt (they differ by
an ulp in about a third of the values): at the rare pair where that ulp
straddles a bf16 rounding boundary of 1/r, the two round 1/r to
neighbouring bf16 values and that pair's term moves by 2^-8 of itself. A
near pair's force can be a few per cent of max|g| (the parity run's 4
steps: one such pair, 1.1e-4 of max|g|); its potential is a far smaller
share of phi (1.6e-5). Every test also measures the gap between the bf16
and f32 results and asserts it is at least 1e-4 somewhere (a no-op would
otherwise pass); the slice's tolerances stay 10x below that gap on every
field they hold but pos, which 4 steps move by less. One PyTorch thread.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu.models import planet as jp
from planetmodel_sph_tpu.ops import structure as js
from planetmodel_sph_tpu.ops.pallas import fallback
from planetmodel_sph_tpu.ops.pallas import groups2 as jk
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.models import planet as tp
from planetmodel_sph_tpu_torch.ops import structure as ts
from planetmodel_sph_tpu_torch.ops.cuda import groups2 as tk
from planetmodel_sph_tpu_torch.ops.cuda import launch
from test_torch_groups2 import B, G, _case, _cols, _grav_inputs, _j, _np, _t
from test_torch_groups2_modes import _blk_rows, _near_rows
from test_torch_pair_skip import _c_test

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 128
GAP = 1e-4            # the least bf16-vs-f32 difference each test must see
# the slice's tolerances, of each field's largest magnitude
SLICE_TOL = dict(phi=5e-5, grad_phi=2.5e-4, accel=2e-5, vel=1e-5, pos=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gravity_close(out, ref, f32):
    """The kernel tolerances (phi 1e-5 relative, g 1e-5 of max|g|, counts
    exact), and the bf16 result at least GAP away from the f32 one."""
    out = [np.asarray(o) for o in out]
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, err_msg="phi")
    gscale = max(np.abs(r).max() for r in ref[1:4])
    for k in range(1, 4):
        np.testing.assert_allclose(out[k], ref[k], rtol=0.0,
                                   atol=1e-5 * gscale, err_msg=f"g{k}")
    for k in range(4, len(ref)):
        np.testing.assert_array_equal(out[k], ref[k])
    gap = max(np.abs(ref[k] - f32[k]).max() / (gscale if k else np.abs(
        f32[0]).max()) for k in range(4))
    assert gap >= GAP, gap


@pytest.mark.parametrize("receiver", [False, True],
                         ids=["min_h", "receiver_h"])
def test_p2p_bf16_matches_jax(receiver):
    """Both softenings; group 0 has nv = 0 and group 1 nv below S."""
    nv, tgt, src = _case(11)
    assert 0 < nv[1] < src[0].shape[1]
    rows = [src[0], src[1], src[2], src[4]] if receiver else src
    jargs = (jnp.asarray(nv), _j(_cols(tgt)), _j(rows))
    ref = _np(jk.p2p(*jargs, b=B, chunk=CHUNK, receiver_soft=receiver,
                     g_const=1.3, bf16=True))
    f32 = _np(fallback.p2p(*jargs, receiver_soft=receiver, g_const=1.3))
    out = tk.p2p(torch.from_numpy(nv), _t(_cols(tgt)), _t(rows), b=B,
                 receiver_soft=receiver, g_const=1.3, bf16=True)
    _gravity_close(out, ref, f32)
    # the self pair of each group's first target stays counted
    assert int(out[4][B]) == int((src[4][1, :nv[1]] > 0).sum())


def _gravity_both(args, kw):
    """(the JAX bf16 branch, the JAX f32 result) of one gravity_fused
    call; args = (nv_p2p, nv_ring, tgt, p2p_rows, ring, far, accept)."""
    ref = _np(jk.gravity_fused(*args, b=B, chunk=CHUNK, g_const=1.3,
                               bf16=True, **kw))
    f32 = _np(fallback.gravity_fused(*args, g_const=1.3, **kw))
    return ref, f32


def _jgrav(nv_ring, tgt, ring, far, accept, nvp=None, prow=None):
    return (None if nvp is None else jnp.asarray(nvp), jnp.asarray(nv_ring),
            _j(tgt), None if prow is None else _j(prow), _j(ring), _j(far),
            jnp.asarray(accept))


@pytest.mark.parametrize("nm", [4, 10])
def test_gravity_fused_bf16_far_only_matches_jax(nm):
    """The RESPA outer force: ring and far monopoles in bf16, the
    quadrupole (nm = 10) in f32."""
    nv_ring, tgt, ring, far, accept = _grav_inputs(12, nm)
    ref, f32 = _gravity_both(_jgrav(nv_ring, tgt, ring, far, accept),
                             dict(receiver_soft=False, has_p2p=False))
    out = tk.gravity_fused(torch.from_numpy(nv_ring), _t(tgt), _t(ring),
                           _t(far), torch.from_numpy(accept), b=B,
                           g_const=1.3, bf16=True)
    _gravity_close(out, ref, f32)
    assert int(out[5].sum()) > 0 and int(out[4].sum()) == 0


@pytest.mark.parametrize("nm,receiver", [(10, False), (4, True)],
                         ids=["quadrupole_min_h", "monopole_receiver_h"])
def test_gravity_fused_bf16_near_tier_matches_jax(nm, receiver):
    nv_ring, tgt, ring, far, accept = _grav_inputs(13, nm)
    nvp, prow = _near_rows(13, receiver)
    ref, f32 = _gravity_both(
        _jgrav(nv_ring, tgt, ring, far, accept, nvp, prow),
        dict(receiver_soft=receiver))
    out = tk.gravity_fused(
        torch.from_numpy(nv_ring), _t(tgt), _t(ring), _t(far),
        torch.from_numpy(accept), b=B, g_const=1.3,
        nv_p2p=torch.from_numpy(nvp), p2p_rows=_t(prow),
        receiver_soft=receiver, bf16=True)
    _gravity_close(out, ref, f32)
    assert int(out[4].sum()) > 0 and int(out[5].sum()) > 0


@pytest.mark.parametrize("near", [False, True], ids=["far_only", "near"])
def test_gravity_fused_bf16_blk_tier_matches_jax(near):
    """The supergroup block tier's monopoles in bf16 too."""
    nv_ring, tgt, ring, far, accept = _grav_inputs(14, 10)
    nvb, brow = _blk_rows(14, 10)
    nvp, prow = _near_rows(14, False)
    blk = dict(nv_blk=jnp.asarray(nvb), blk_rows=_j(brow))
    ref, f32 = _gravity_both(
        _jgrav(nv_ring, tgt, ring, far, accept, *((nvp, prow) if near
                                                   else ())),
        dict(receiver_soft=False, has_p2p=near, **blk))
    nkw = dict(nv_p2p=torch.from_numpy(nvp), p2p_rows=_t(prow)) if near \
        else {}
    out = tk.gravity_fused(torch.from_numpy(nv_ring), _t(tgt), _t(ring),
                           _t(far), torch.from_numpy(accept), b=B,
                           g_const=1.3, nv_blk=torch.from_numpy(nvb),
                           blk_rows=_t(brow), bf16=True, **nkw)
    _gravity_close(out, ref, f32)


def test_cpu_bf16_calls_launch_nothing():
    """On CPU tensors the wrappers take the plain versions, bf16 or not,
    and count no launch; reset_launches zeroes the bf16 tally too."""
    launch.BF16_LAUNCHES["p2p"] = 3
    launch.reset_launches()
    assert set(launch.BF16_LAUNCHES) == {"p2p", "gravity_fused"}
    nv, tgt, src = _case(0)
    tk.p2p(torch.from_numpy(nv), _t(_cols(tgt)), _t(src), b=B,
           receiver_soft=False, bf16=True)
    nv_ring, gt, ring, far, accept = _grav_inputs(0, 4)
    tk.gravity_fused(torch.from_numpy(nv_ring), _t(gt), _t(ring), _t(far),
                     torch.from_numpy(accept), b=B, bf16=True)
    assert all(v == 0 for v in launch.LAUNCHES.values())
    assert all(v == 0 for v in launch.BF16_LAUNCHES.values())


def _source(name):
    with open(os.path.join(ROOT, "planetmodel_sph_tpu_torch", "csrc",
                           name)) as f:
        return f.read()


def test_kernel_constants_are_jax_roundings_and_ops_round():
    """The bf16 constants of csrc/common.cuh are the reference's Python
    constants as JAX rounds them (both lanes), and the bf16 pair body
    rounds every operation (mul/add/sub .rn, no multiply-add)."""
    src = _source("common.cuh")
    want = {"8": 8.0, "9": 9.0, "2": 2.0, "4": 4.0, "3": 3.0, "2P4": 2.4,
            "0P4": 0.4}
    for name, v in want.items():
        m = re.search(rf"#define PSPH_BF_{name} 0x([0-9A-Fa-f]{{8}})u", src)
        assert m, name
        word = int(m.group(1), 16)
        bits = int(torch.tensor(v, dtype=torch.bfloat16).view(torch.int16)
                   ) & 0xFFFF
        assert word >> 16 == word & 0xFFFF == bits, name
    assert float(torch.tensor(2.4, dtype=torch.bfloat16)) == 2.40625
    body = src[src.index("void psph_dyer_ip_bf2("):]
    body = body[:body.index("\n}\n")]
    assert "fma" not in body and "__h" not in body
    for op in ("mul", "add", "sub"):
        assert f'asm("{op}.rn.bf16x2' in src, op
    assert "template <bool RECV, bool BF16>" in _source("p2p.cu")
    assert "template <int HAS_P2P, int NM, bool BF16>" in \
        _source("gravity_fused.cu")


def test_near_tier_compacts_with_the_p2p_predicate():
    """gravity_fused.cu's near tier stages its P2P window with psph_window,
    compacts each tile with p2p.cu's predicate (read from the sources:
    the same expression) and sums f32 pairs through psph_p2p_pair and
    bf16 pairs on psph_dyer_ip_bf2, two compacted slots a lane pair. The
    predicate keeps every slot with m != 0, a dead one (m = 0) whose x,
    y, z or ih is NaN or infinite, and every slot where a target of the
    block has a non-finite column; it drops a dead finite slot."""
    src = _source("gravity_fused.cu")
    near = src[src.index("void near_tier("):]
    near = near[:near.index("\n}\n")]
    keep = re.search(r"return (m != 0\.0f[^;]*);", near)
    p2p = re.search(r"return (m != 0\.0f[^;]*);", _source("p2p.cu"))
    assert keep and p2p and keep.group(1) == p2p.group(1)
    for call in ("psph_window<NR>(", "psph_compact_where(",
                 "psph_p2p_pair(", "psph_dyer_ip_bf2(", "j += 2 * ns"):
        assert call in near, call
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    m = np.array([1.0, -1.0, nan, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                 np.float32)
    x = np.array([0.5, 0.5, 0.5, 0.5, nan, inf, -inf, 0.5, 0.5],
                 np.float32)
    ih = np.array([2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, nan, inf],
                  np.float32)
    y = z = np.zeros_like(x)
    for keep_all in (False, True):
        got = _c_test(keep.group(1))(m=m, keep_all=np.asarray(keep_all),
                                     v=np.stack([x, y, z, ih]))
        assert got.tolist() == ([True] * 9 if keep_all else
                                [True] * 3 + [False] + [True] * 5)


def test_structure_threads_bf16_to_the_sweeps_not_pass2(monkeypatch):
    """``bf16=True`` reaches p2p and both gravity_fused forms under
    grav_pair_dtype='bfloat16' and never pass 2's merged near window (the
    reference passes it no bf16)."""
    seen = []
    for name in ("p2p", "gravity_fused", "pass2"):
        orig = getattr(tk, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, kw.get("bf16")))
            return _orig(*a, **kw)
        monkeypatch.setattr(tk, name, spy)
    n = 256
    kw = dict(n=n, radius=30.0, particle_radius=3.0,
              neighbor_mode="grid", gravity_solver="tree",
              nbr_group_size=32, nbr_sub=16, nbr_group_level=2,
              nbr_window=128, p2p_window=256, m2p_window=128,
              grav_pair_dtype="bfloat16")
    pos, h, mass = (torch.from_numpy(v) for v in _cloud(n, seed=1))
    for fused in (False, True):
        cfg = tc.SimConfig(**kw, fuse_p2p_sph=fused,
                           fuse_p2p_residual=fused)
        st = ts.build(pos, h, mass, cfg)
        for tiers in ("near", "far", "all"):
            ts.forces(pos, h, mass, cfg, st, grav_tiers=tiers)
    got = set(seen)
    assert ("p2p", True) in got and ("gravity_fused", True) in got
    assert ("pass2", None) in got
    assert {n for n, b in got if b is not True} == {"pass2"}


def _cloud(n=512, seed=5, radius=10.0):
    """The reference test's cloud (normal positions, h in [1, 2), equal
    masses), from numpy."""
    rng = np.random.default_rng(seed)
    pos = (radius * rng.normal(size=(n, 3))).astype(np.float32)
    h = (1.0 + rng.uniform(size=n)).astype(np.float32)
    return pos, h, np.full(n, 0.05, np.float32)


STRUCT = dict(n=512, neighbor_mode="grid", gravity_solver="tree",
              nbr_group_size=64, nbr_window=128, p2p_window=128,
              m2p_window=128, nbr_group_level=2, block_chunk=512,
              grad_p_mode="symmetric")


def _slice_close(out, ref, f32, name, tol, gap_checked=True):
    """out within tol of the field's largest magnitude; where gap_checked,
    the bf16-vs-f32 gap at least 10 tol (for phi and grad phi that is also
    the GAP every test must see)."""
    out, ref, f32 = (np.asarray(v) for v in (out, ref, f32))
    scale = np.abs(f32).max()
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=tol * scale,
                               err_msg=name)
    if gap_checked:
        gap = np.abs(ref - f32).max() / scale
        assert gap >= 10.0 * tol, (name, gap)


@pytest.mark.parametrize("gb", [1, 2])
def test_structure_gravity_bf16_matches_jax(gb):
    """``structure.gravity`` on the reference test's cloud at
    kernel_gb = gb: the port against the JAX package at the same gb (whose
    interpret-mode kernels then take gb groups a grid step), counters
    exact; on the port kernel_gb changes no bit."""
    pos, h, mass = _cloud()
    jcfg = jc.SimConfig(**STRUCT, kernel_gb=gb)
    jst = jax.jit(lambda p, hh, m: js.build(p, hh, m, jcfg))(pos, h, mass)
    f32, ref = (jax.jit(lambda p, hh, m, st, c=c: js.gravity(
        p, hh, m, c, st))(pos, h, mass, jst)
        for c in (jcfg, jcfg.replace(grav_pair_dtype="bfloat16")))
    T = torch.from_numpy
    tcfg = tc.SimConfig(**STRUCT, kernel_gb=gb,
                        grav_pair_dtype="bfloat16")
    tst = ts.build(T(pos), T(h), T(mass), tcfg)
    out = ts.gravity(T(pos), T(h), T(mass), tcfg, tst)
    _slice_close(out[0], ref[0], f32[0], "phi", SLICE_TOL["phi"])
    _slice_close(out[1], ref[1], f32[1], "grad_phi", SLICE_TOL["grad_phi"])
    for k in (2, 3):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    if gb > 1:
        one = ts.gravity(T(pos), T(h), T(mass), tcfg.replace(kernel_gb=1),
                         tst)
        for a, b in zip(out, one):
            assert torch.equal(a, b)


GRID = dict(n=384, radius=30.0, particle_radius=3.0, neighbor_mode="grid",
            gravity_solver="tree", nbr_group_size=32, nbr_sub=16,
            nbr_group_level=2, nbr_window=128, p2p_window=256,
            m2p_window=128, multipole_order=2, theta=1.0,
            grav_com_correction=True, sort_every=8)
RUNS = {
    # unfused symmetric step in cached RESPA chunks: p2p each inner step,
    # the far-only launch each period, every tier in the priming pass
    "sym_respa": dict(GRID, grad_p_mode="symmetric", h_mode="relax",
                      sph_refine_subblock=True, sph_refined_window=64,
                      h_track_margin=0.04, rebuild_every=4, respa_every=2),
    # dense SPH, tree gravity from a fresh structure each step
    "parity": dict(vars(tc.parity(n=384, radius=20.0, particle_radius=4.0,
                                  nbr_group_level=2))),
}
STEPS = 4


@pytest.mark.parametrize("name", sorted(RUNS))
def test_steps_bf16_match_jax(name):
    """Priming + 4 steps under grav_pair_dtype='bfloat16', the port
    against the JAX package, beside the f32 run of the same steps (the
    port's, which tests/test_torch_grid_step.py holds to the JAX
    package's)."""
    kw = RUNS[name]
    uncached = dict(rebuild_every=1, respa_every=1)
    jcfg = jc.SimConfig(**dict(kw, grav_pair_dtype="bfloat16"))
    st0 = jics.jupiter(jcfg)
    arrays = {k: np.asarray(v) for k, v in vars(st0).items()}
    j0 = jax.jit(lambda s: jp.prime(s, jcfg.replace(**uncached)))(st0)
    j1, jinfo = jp.run_info(j0, jcfg, STEPS)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        tcfg = tc.SimConfig(**dict(kw, grav_pair_dtype=dtype))
        out0 = tp.prime(tstate.from_numpy(arrays, device="cpu"),
                        tcfg.replace(**uncached))
        runs[dtype] = (out0, *tp.run_info(out0, tcfg, STEPS))
    (f0, f1, _), (out0, out, info) = runs["float32"], runs["bfloat16"]
    for k in ("phi", "grad_phi"):
        _slice_close(getattr(out0, k), getattr(j0, k), getattr(f0, k),
                     f"{k} after priming", SLICE_TOL[k])
    for k in ("phi", "grad_phi", "accel", "vel", "pos"):
        # 4 steps move the positions by less than the gap rule could see
        _slice_close(getattr(out, k), getattr(j1, k), getattr(f1, k),
                     f"{k} after {STEPS} steps", SLICE_TOL[k],
                     gap_checked=k != "pos")
    for k in ("n_neighbors", "n_direct", "n_approx"):
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(j1, k)), err_msg=k)
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in jinfo.items()}
