"""What the compacted sweeps ``csrc/pass1_gradh.cu``, ``csrc/pass1_sym.cu``,
``csrc/pass2.cu`` and ``csrc/p2p.cu`` keep exact when they visit only some
pairs, and what the all-pairs kernels keep when they gate pairs out.

The kernels visit only the live slots of a window (m != 0; padding and
duplicates carry m = 0), pass 1 skips a pair with (r2 ih) ih >
PSPH_Q2_SKIP before its square root, pass1_sym one with (r2 ihm) ihm >
PSPH_Q2_SKIP, ihm the smaller ih (the larger support: the either-support
skip), and pass 2 adds its SPH terms only where r ih_i < 2 or r ih_j < 2
(gravity still takes every live pair). None leaves out a pair of a tile
(PSPH_TILE slots) in which a kept slot holds a non-finite staged value,
nor one of a target with a non-finite column (``all_pairs``): in the
plain versions a NaN or an infinity times a weight of 0 is NaN. pass1_sym
and p2p also keep a dead slot (m = 0) with a non-finite field, from which
their plain versions form NaN, and p2p every slot of a block with a
non-finite target. The CUDA kernels run only on the card; here

- the two tests are read from the sources as C expressions and evaluated
  on numpy float32 arrays (``_c_test``), and held, in numpy and as a
  hypothesis property over ih and knife-edge r (r2 built as the kernel
  builds it), to never skip a pair with sqrt(r2) ih < 2 and never a NaN;
- the plain versions on inputs with dead slots and pairs at q = 2 +- 1 ulp
  are held against the same plain versions applied, target by target, to
  just the slots the kernels visit: counts bit-equal, sums within the
  tolerances of tests/test_torch_groups2_modes.py;
- with a NaN (and an infinity) planted in each field the kernels stage,
  one at a time, at a live slot outside the support of a target, or in a
  target's own column, the pairs the kernels visit (their tests and the
  all_pairs flags as the sources state them) give NaN exactly where the
  plain version over every pair does.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from planetmodel_sph_tpu_torch.ops.cuda import groups2 as tk
from test_torch_groups2 import B, _case, _close, _cols, _t
from test_torch_groups2_modes import (PASS2_CASES, _check_pass2,
                                      _pass2_inputs)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "planetmodel_sph_tpu_torch", "csrc")


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _skip_constant():
    m = re.search(r"#define\s+PSPH_Q2_SKIP\s+([0-9.eE+-]+)f",
                  _source("common.cuh"))
    assert m, "PSPH_Q2_SKIP not found in common.cuh"
    return np.float32(m.group(1))


Q2_SKIP = _skip_constant()

# C's float functions with their NaN rules (fminf and fmaxf return the
# other operand; psph_min and psph_max, min.NaN.f32 and max.NaN.f32,
# return NaN)
def _fmaf(a, b, c):
    """fmaf in float32: the product of two float32 values is exact in
    float64, so a * b + c rounds once there and once to float32 (the two
    roundings can differ from one only at a float32 halfway point)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


_C_CALLS = {"fminf": np.fmin, "fmaxf": np.fmax, "sqrtf": np.sqrt,
            "__fsqrt_rn": np.sqrt,
            "psph_min": np.minimum, "psph_max": np.maximum,
            "isfinite": np.isfinite,
            "psph_all_finite": lambda v: np.isfinite(v).all(axis=0),
            "__fmul_rn": np.multiply, "__fadd_rn": np.add, "fmaf": _fmaf}


def _c_test(expr, calls=None):
    """A C float expression of the kernels (names, float literals, * + -,
    comparisons, && || !, a ? b : c, fminf/fmaxf/sqrtf/fmaf, __fsqrt_rn,
    __fmul_rn and __fadd_rn, INFINITY; a per-target subscript [u] is
    dropped) as a function of numpy float32 arrays given by name, with C's
    rounding and NaN rules. `calls`: more functions by name (a kernel's
    own helpers)."""
    calls = {**_C_CALLS, **(calls or {})}
    py = re.sub(r"(\d+\.\d*(?:[eE][+-]?\d+)?)f\b", r"\1", expr)
    py = py.replace("[u]", "").replace("INFINITY", "float('inf')")
    py = py.replace("&&", " and ").replace("||", " or ")
    py = re.sub(r"!(?!=)", " not ", py)
    m = re.fullmatch(r"\s*(.+?)\s*\?\s*(.+?)\s*:\s*(.+?)\s*", py)
    if m:
        py = f"({m.group(2)}) if ({m.group(1)}) else ({m.group(3)})"
    tree = ast.parse(py.strip(), mode="eval").body
    ops = {ast.Mult: np.multiply, ast.Add: np.add, ast.Sub: np.subtract,
           ast.Gt: np.greater, ast.GtE: np.greater_equal, ast.Lt: np.less,
           ast.LtE: np.less_equal, ast.NotEq: np.not_equal}

    def ev(n, env):
        if isinstance(n, ast.Constant):
            return np.float32(n.value)
        if isinstance(n, ast.Name):
            return env[n.id]
        if isinstance(n, ast.BinOp):
            return ops[type(n.op)](ev(n.left, env), ev(n.right, env))
        if isinstance(n, ast.Compare):
            (op,), (right,) = n.ops, n.comparators
            return ops[type(op)](ev(n.left, env), ev(right, env))
        if isinstance(n, ast.BoolOp):
            f = np.logical_and if isinstance(n.op, ast.And) \
                else np.logical_or
            out = ev(n.values[0], env)
            for v in n.values[1:]:
                out = f(out, ev(v, env))
            return out
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            return np.logical_not(ev(n.operand, env))
        if isinstance(n, ast.IfExp):
            return np.where(ev(n.test, env), ev(n.body, env),
                            ev(n.orelse, env)).astype(np.float32)
        if isinstance(n, ast.Call) and n.func.id == "float":
            return np.float32(n.args[0].value)
        if isinstance(n, ast.Call):
            return calls[n.func.id](*(ev(a, env) for a in n.args))
        raise ValueError(f"not a kernel test expression: {expr}")

    def run(**env):
        with np.errstate(invalid="ignore", over="ignore"):
            return ev(tree, {k: np.asarray(v, np.float32)
                             for k, v in env.items()})
    return run


def _kernel_tests():
    """pass1_gradh.cu's ih_skip and visit test, pass2.cu's SPH gate, the
    all_pairs flag of both and pass2.cu's gravity softening: the C
    expressions as the sources have them."""
    p1, p2 = _source("pass1_gradh.cu"), _source("pass2.cu")
    ih_skip = re.search(r"const float ih_skip = ([^;]+);", p1)
    visit = re.search(r"if \((.*PSPH_Q2_SKIP.*)\) \{", p1)
    gate = re.search(r"if \((.*\br \* .*)\) \{\s*// inside the support",
                     p2)
    flags = [re.search(r"const bool all_pairs = ([^;]+);", src)
             for src in (p1, p2)]
    ih_tile = re.search(r"const float ih_tile = ([^;]+);", p1)
    ih_gate = re.search(r"const float ih_gate = ([^;]+);", p2)
    soft = re.search(r"RECV \? ih : ([^,;]+\(ih, jh\))", p2)
    assert ih_skip and visit and gate and all(flags) and ih_tile and \
        ih_gate and soft, "a kernel's pair test was not found"
    assert flags[0].group(1) == flags[1].group(1)
    return (_c_test(ih_skip.group(1)), _c_test(ih_tile.group(1)),
            _c_test(visit.group(1)), _c_test(ih_gate.group(1)),
            _c_test(gate.group(1)), _c_test(flags[0].group(1)),
            _c_test(soft.group(1)))


(IH_SKIP, IH_TILE, P1_TEST, IH_GATE, P2_TEST, ALL_PAIRS,
 P2_SOFTENING) = _kernel_tests()


def P1_VISIT(r2, ih_skip, PSPH_Q2_SKIP, all_pairs):
    """pass1_gradh.cu's visit test: its skip on the tile's ih."""
    return P1_TEST(r2=r2, PSPH_Q2_SKIP=PSPH_Q2_SKIP,
                   ih_tile=IH_TILE(all_pairs=all_pairs, ih_skip=ih_skip))


def P2_GATE(r, ih, jh, all_pairs):
    """pass2.cu's SPH gate on the tile's ih."""
    return P2_TEST(r=r, jh=jh, ih_gate=IH_GATE(all_pairs=all_pairs, ih=ih))
TILE = int(re.search(r"#define\s+PSPH_TILE\s+(\d+)",
                     _source("common.cuh")).group(1))


def _sym_and_p2p_tests():
    """pass1_sym.cu's target and source skip ih, pair ih, visit test and
    flag, and the compaction predicates of pass1_sym.cu and p2p.cu: the
    C expressions as the sources have them."""
    sym, p2p = _source("pass1_sym.cu"), _source("p2p.cu")
    ih_skip = re.search(r"const float ih_skip = ([^;]+);", sym)
    jh_skip = re.search(r"geo\[at\] = make_float4\(v\[0\], v\[1\], "
                        r"v\[2\], ([^;]+)\);", sym)
    ih_tile = re.search(r"const float ih_tile = ([^;]+);", sym)
    ihm = re.search(r"const float ihm = ([^;]+);", sym)
    visit = re.search(r"if \((.*PSPH_Q2_SKIP.*)\) \{", sym)
    flag = re.search(r"const bool all_pairs = ([^;]+);", sym)
    keeps = [re.search(r"return (m != 0\.0f[^;]*);", src)
             for src in (sym, p2p)]
    assert ih_skip and jh_skip and ih_tile and ihm and visit and flag \
        and all(keeps), "a pair test of pass1_sym.cu or p2p.cu was not found"
    # the source's skip ih rides in the slot's float4 as p.w
    return (_c_test(ih_skip.group(1)), _c_test(jh_skip.group(1)),
            _c_test(ih_tile.group(1)),
            _c_test(ihm.group(1).replace("p.w", "jh_skip")),
            _c_test(visit.group(1)), _c_test(flag.group(1)),
            _c_test(keeps[0].group(1)), _c_test(keeps[1].group(1)))


(S_IH_SKIP, S_JH_SKIP, S_IH_TILE, S_IHM, S_TEST, S_ALL_PAIRS, SYM_KEEP,
 P2P_KEEP) = _sym_and_p2p_tests()


def _sym_skipped(r2, ih, jh, all_pairs=False):
    """pass1_sym.cu's either-support skip, in float32, as its source
    states it."""
    ih_tile = S_IH_TILE(all_pairs=np.asarray(all_pairs),
                        ih_skip=S_IH_SKIP(ih=ih))
    ihm = S_IHM(ih_tile=ih_tile, jh_skip=S_JH_SKIP(jh=jh))
    return ~np.asarray(S_TEST(r2=r2, ihm=ihm, PSPH_Q2_SKIP=Q2_SKIP))


def _sym_fields(x, y, z, jh, m):
    """The staged fields pass1_sym.cu tests for finiteness (its `fields`):
    x, y, z, ih^3 formed as the kernel forms it, m."""
    jh = np.asarray(jh, np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.stack([np.asarray(v, np.float32) for v in
                         (x, y, z, jh * jh * jh, m)])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the tight tolerances here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skipped(r2, ih, all_pairs=False):
    """pass1_gradh.cu's skip, in float32, as its source states it."""
    return ~P1_VISIT(r2=r2, ih_skip=IH_SKIP(ih=ih), PSPH_Q2_SKIP=Q2_SKIP,
                     all_pairs=np.asarray(all_pairs))


def _r2(dx, dy, dz):
    """r2 as the kernel forms it (separate float32 operations)."""
    return dx * dx + dy * dy + dz * dz


def _q(r2, ih):
    with np.errstate(invalid="ignore"):
        return np.sqrt(r2) * ih


def test_skip_constant_and_the_kernels_test():
    """The constant is 4 (1 + 2^-12); pass 1's skip keeps every pair of a
    NaN or non-positive ih, and pass 2's gate, on finite values, is r
    min(ih_i, ih_j) < 2 and visits every pair with a NaN in r, ih or jh."""
    assert Q2_SKIP == np.float32(4.0) * (1 + np.float32(2.0) ** -12)
    # the pair that is visited takes q as the plain version does
    assert "const float q = sqrtf(r2) * ih;" in _source("pass1_gradh.cu")
    nan = np.float32(np.nan)
    ih = np.array([nan, 0.0, -1.0, 2.0], np.float32)
    assert IH_SKIP(ih=ih)[:3].tolist() == [0.0, 0.0, 0.0]
    rng = np.random.default_rng(3)
    n = 20_000
    ih = (10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)
    jh = (ih * 10.0 ** rng.uniform(-1, 1, n)).astype(np.float32)
    k = rng.integers(-64, 65, n)
    r = ((2.0 / np.minimum(ih, jh).astype(np.float64))
         * (1 + k * 2.0 ** -24)).astype(np.float32)
    inside = r * np.minimum(ih, jh) < 2.0
    assert 0 < inside.sum() < n
    off = np.zeros(n, bool)
    np.testing.assert_array_equal(
        P2_GATE(r=r, ih=ih, jh=jh, all_pairs=off), inside)
    far = np.float32(1e3)
    for r_, ih_, jh_ in ((far, 1.0, nan), (far, nan, 1.0), (nan, 1.0, 1.0),
                         (far, nan, nan)):
        assert P2_GATE(r=r_, ih=ih_, jh=jh_, all_pairs=False), \
            (r_, ih_, jh_)
    assert not P2_GATE(r=far, ih=1.0, jh=1.0, all_pairs=False)
    # the flag opens both tests for every pair
    assert P2_GATE(r=far, ih=1.0, jh=1.0, all_pairs=True)
    assert not _skipped(np.float32(1e6), np.float32(1.0), True)


def _knife_edges(rng, n, rel):
    """n pairs at |r| = (2 / ih) * rel * (1 + k 2^-24), k in [-256, 256],
    in random directions, ih over six decades."""
    ih = (10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0)
    k = rng.integers(-256, 257, n)
    r = (2.0 / ih.astype(np.float64)) * rel * (1 + k * 2.0 ** -24)
    dx, dy, dz = (np.float32(1) * (r * c).astype(np.float32) for c in u)
    return _r2(dx, dy, dz), ih


@pytest.mark.parametrize("rel", [1.0, float(np.sqrt(Q2_SKIP / 4.0))],
                         ids=["q_at_2", "at_the_skip_threshold"])
def test_a_skipped_pair_is_outside_the_support_numpy(rel):
    rng = np.random.default_rng(7)
    r2, ih = _knife_edges(rng, 400_000, rel)
    skip = _skipped(r2, ih)
    assert not np.any(skip & (_q(r2, ih) < 2.0))
    if rel == 1.0:
        assert not skip.any()          # q within 256 ulps of 2: all kept
    else:
        assert 0 < skip.sum() < skip.size   # both sides of the threshold


@settings(max_examples=300, deadline=None)
@given(log_ih=st.floats(-3.0, 3.0), k=st.integers(-4096, 4096),
       ux=st.floats(-1.0, 1.0), uy=st.floats(-1.0, 1.0),
       uz=st.floats(-1.0, 1.0))
def test_a_skipped_pair_is_outside_the_support_property(log_ih, k, ux, uy,
                                                         uz):
    norm = np.sqrt(ux * ux + uy * uy + uz * uz)
    if norm < 1e-3:
        ux, uy, uz, norm = 1.0, 0.0, 0.0, 1.0
    ih = np.float32(10.0 ** log_ih)
    r = (2.0 / float(ih)) * (1 + k * 2.0 ** -24)
    dx, dy, dz = (np.float32(r * c / norm) for c in (ux, uy, uz))
    r2 = _r2(dx, dy, dz)
    if _skipped(np.float32(r2), ih):
        assert _q(r2, ih) >= 2.0


def test_nan_and_non_positive_ih_are_never_skipped():
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    r2 = np.array([nan, 1e6, nan, inf, 1e6, 1e6, inf], np.float32)
    ih = np.array([1.0, nan, nan, 0.0, 0.0, -5.0, nan], np.float32)
    assert not _skipped(r2, ih).any()
    # far pairs of a positive ih are skipped, and inf too
    assert _skipped(np.array([1e6, inf], np.float32),
                    np.array([1.0, 1.0], np.float32)).all()


# ---------------------------------------------------------------------------
# the plain versions on the pairs the kernels visit
# ---------------------------------------------------------------------------

def _plant_knife_edges(nv, tgt, src):
    """Target 0 of each group at the origin with ih = 2 (h = 0.5); slots
    8-10 at q = 2, 2 - 1 ulp and 2 + 1 ulp along x, with ih = 2 too, and
    slot 11 a dead copy of slot 9."""
    b = tgt[0].shape[0] // src[0].shape[0]
    edge = np.array([1.0, np.nextafter(np.float32(1), np.float32(0)),
                     np.nextafter(np.float32(1), np.float32(2))], np.float32)
    for gi in range(src[0].shape[0]):
        t = gi * b
        for c in tgt[:3]:
            c[t] = 0.0
        tgt[3][t] = 2.0
        src[0][gi, 8:11] = edge
        src[1][gi, 8:12] = 0.0
        src[2][gi, 8:12] = 0.0
        src[3][gi, 8:12] = 2.0
        src[4][gi, 8:11] = 1.0
        src[0][gi, 11], src[4][gi, 11] = edge[1], 0.0
    assert 2.0 * edge[1] == np.nextafter(np.float32(2), np.float32(0))
    assert 2.0 * edge[2] == np.nextafter(np.float32(2), np.float32(4))


def _visited(nv, rows, keep):
    """The slots each target visits (keep: [G, B, S] bool), in slot order,
    as G*B groups of one target: (nv', rows')."""
    g, b, s = keep.shape
    k = keep.reshape(g * b, s)
    n = k.sum(dim=1)
    order = torch.argsort((~k).to(torch.int8), dim=1, stable=True)
    order = order[:, :max(int(n.max()), 1)]
    return n.to(torch.int32), [
        torch.gather(r.repeat_interleave(b, dim=0), 1, order).contiguous()
        for r in rows]


def _geometry(nv, tgt, src):
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    tx, ty, tz, tih = (c.reshape(g, b, 1) for c in tgt[:4])
    sx, sy, sz = (r[:, None, :] for r in src[:3])
    below = torch.arange(s)[None, None, :] < nv.reshape(g, 1, 1)
    dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
    return below, dxx * dxx + dxy * dxy + dxz * dxz, tih


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pass1_on_the_visited_pairs_matches(seed):
    nv, tgt, src = _case(seed)
    _plant_knife_edges(nv, tgt, src)
    nv, tgt = torch.from_numpy(nv), _t(_cols(tgt))
    rows = _t([src[0], src[1], src[2], src[4]])
    below, r2, tih = _geometry(nv, tgt, rows)
    live = below & (rows[3][:, None, :] != 0.0)
    skip = torch.from_numpy(_skipped(r2.numpy(), tih.numpy(),
                                     _all_pairs(nv, tgt, rows, 3).numpy()))
    keep = live & ~skip
    assert int((below & ~live).sum()) > 0 and int((live & skip).sum()) > 0
    # the knife edges are visited: q = 2 - 1 ulp counts, 2 and 2 + 1 ulp
    # do not, and the dead copy is not visited
    q = torch.sqrt(r2) * tih
    g1 = int(torch.nonzero(nv > 12)[0])
    assert keep[g1, 0, 8:11].all() and not keep[g1, 0, 11]
    assert (q[g1, 0, 8:11] < 2.0).tolist() == [False, True, False]
    ref = tk.pass1_gradh_plain(nv, tgt, rows)
    nv1, rows1 = _visited(nv, rows, keep)
    out = tk.pass1_gradh_plain(nv1, tgt, rows1)
    _close(out[1], ref[1], 0)
    _close(out[0], ref[0], 2e-6)
    _close(out[2], ref[2], 1e-5, 1e-6 * float(ref[2].abs().max()))


def _all_pairs(nv, tgt, rows, m_row):
    """[G, B, S] all_pairs as the kernels form it: ALL_PAIRS of the tile
    flag (psph_compact: some live slot of the slot's tile, PSPH_TILE slots,
    holds a non-finite value in one of the staged rows) and the target
    flag (a non-finite value in one of the target's columns)."""
    g, s = rows[0].shape
    b = tgt[0].shape[0] // g
    below = torch.arange(s)[None, :] < nv[:, None]
    live = below & (rows[m_row] != 0.0)
    bad = live & ~torch.stack([torch.isfinite(r) for r in rows]).all(0)
    pad = -s % TILE
    tiles = torch.nn.functional.pad(bad, (0, pad)).reshape(g, -1, TILE)
    tile_bad = tiles.any(dim=2).repeat_interleave(TILE, dim=1)[:, :s]
    target_bad = ~torch.stack([torch.isfinite(c.reshape(g, b))
                               for c in tgt]).all(0)
    return torch.from_numpy(np.asarray(ALL_PAIRS(
        tile_bad=tile_bad[:, None, :].numpy(),
        target_bad=target_bad[:, :, None].numpy()))).expand(g, b, s)


def _gate(nv, tgt, src):
    """Live SPH pairs and those that pass pass2.cu's gate."""
    below, r2, tih = _geometry(nv, tgt, src)
    live = below & (src[4][:, None, :] != 0.0)
    r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))
    gate = P2_GATE(r=r.numpy(), ih=tih.numpy(),
                   jh=src[3][:, None, :].numpy(),
                   all_pairs=_all_pairs(nv, tgt, src, 4).numpy())
    inside = live & torch.from_numpy(np.asarray(gate))
    return live.expand(inside.shape), inside


def _plant_nans(nv, tgt, src):
    """In the last group with more than 16 live slots: a NaN ih of
    target 1 and a NaN jh (source ih) at slot 14, a live slot outside the
    support of target 0, which sits at the origin with ih = 2."""
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    gi = int(np.nonzero(nv > 16)[0][-1])
    src[0][gi, 14], src[1][gi, 14], src[2][gi, 14] = 5.0, 0.0, 0.0
    src[4][gi, 14] = 1.0
    src[3][gi, 14] = np.nan
    tgt[3][gi * b + 1] = np.nan
    return gi


def _check_pass2_nans(out, ref, f):
    """NaN at the same places, the rest as _check_pass2 holds it."""
    ref_nan = [torch.isnan(r) for r in ref]
    assert any(bool(m.any()) for m in ref_nan)
    for o, m in zip(out, ref_nan):
        assert torch.equal(torch.isnan(o), m)
    _check_pass2([torch.where(m, 0.0, o) if o.is_floating_point() else o
                  for o, m in zip(out, ref_nan)],
                 [torch.where(m, 0.0, r) if r.is_floating_point() else r
                  for r, m in zip(ref, ref_nan)], f)


def _live_window(nv, rows, b):
    """Every live slot of a window, for each of its b targets."""
    g, s = rows[0].shape
    below = torch.arange(s)[None, :] < nv[:, None]
    keep = (below & (rows[-1] != 0.0))[:, None, :].expand(g, b, s)
    return _visited(nv, rows, keep)


def _pass2_case(f, seed=3):
    """(nv, tgt, src, kw, tkw) of a pass-2 case with the knife edges."""
    nv, tgt, src, pkw = _pass2_inputs(seed, f["mode"], f["av"],
                                      f["balsara"], f["merged"],
                                      f["receiver"], energy=f["energy"])
    _plant_knife_edges(nv, tgt, src)
    kw = dict(mode=f["mode"], av=f["av"], balsara=f["balsara"],
              energy=f["energy"], sign_bug=f["sign_bug"], av_alpha=1.0,
              av_beta=2.0, receiver_soft=f["receiver"], g_const=0.7)
    return nv, tgt, src, kw, pkw


def _pass2_visited(nv, tgt, src, kw, pkw, f):
    """(the plain version over every pair, the plain version over the
    pairs pass2.cu visits, live, inside): the SPH terms from the pairs
    inside the gate, gravity and n_direct from every live slot of both
    windows."""
    nv, tgt, src = torch.from_numpy(nv), _t(tgt), _t(src)
    tkw = {}
    if f["merged"]:
        tkw = dict(nv_p2p=torch.from_numpy(pkw["nv_p2p"]),
                   p2p_rows=_t(pkw["p2p_rows"]))
    ref = tk.pass2_plain(nv, tgt, src, grav=f["grav"], **kw, **tkw)
    live, inside = _gate(nv, tgt, src)
    nv_s, rows_s = _visited(nv, src, inside)
    out = list(tk.pass2_plain(nv_s, tgt, rows_s, grav=False, **kw))
    if f["grav"]:
        nv_g, rows_g = _visited(nv, src, live)
        gkw = {}
        if f["merged"]:
            nv_p, rows_p = _live_window(tkw["nv_p2p"], tkw["p2p_rows"], B)
            gkw = dict(nv_p2p=nv_p, p2p_rows=rows_p)
        out += list(tk.pass2_plain(nv_g, tgt, rows_g, grav=True, **kw,
                                   **gkw))[-5:]
    return ref, out, live, inside


@pytest.mark.parametrize("case", sorted(PASS2_CASES))
def test_pass2_on_the_visited_pairs_matches(case):
    f = PASS2_CASES[case]
    nv, tgt, src, kw, pkw = _pass2_case(f)
    gi = _plant_nans(nv, tgt, src)
    ref, out, live, inside = _pass2_visited(nv, tgt, src, kw, pkw, f)
    assert int((live & ~inside).sum()) > 0          # the gate drops pairs
    # the NaN source ih is visited by the target outside its support
    assert bool(inside[gi, 0, 14])
    assert torch.equal(inside[gi, 1], live[gi, 1])  # the NaN target's
    _check_pass2_nans(out, ref, f)


def _check_non_finite(out, ref, check):
    """NaN and infinities at the same places (same infinities), the rest
    held by check(out, ref) with the non-finite places set to 0."""
    fixed = [[], []]
    for o, r in zip(out, ref):
        if not r.is_floating_point():
            fixed[0].append(o)
            fixed[1].append(r)
            continue
        assert torch.equal(torch.isnan(o), torch.isnan(r))
        inf = torch.isinf(r)
        assert torch.equal(torch.isinf(o), inf)
        assert torch.equal(o[inf], r[inf])
        fin = torch.isfinite(r)
        fixed[0].append(torch.where(fin, o, 0.0))
        fixed[1].append(torch.where(fin, r, 0.0))
    check(*fixed)


SRC_NAMES = ("x", "y", "z", "ih", "m", "cc", "vx", "vy", "vz", "h", "cs",
             "rho", "f")


def _tgt_names(f):
    names = ["x", "y", "z", "ih"] + (
        [] if f["mode"] == "reference_asymmetric" else ["tc"])
    if f["av"]:
        names += ["vx", "vy", "vz", "h", "cs", "rho"] + (
            ["f"] if f["balsara"] else [])
    elif f["energy"]:
        names += ["vx", "vy", "vz"]
    return names


# three forms that between them stage every row pass2.cu has: viscosity,
# Balsara, energy and the merged gravity; the energy equation's velocities
# without viscosity; the asymmetric form without a target coefficient
NAN_CASES = ("grad_h+av+balsara+energy+merged", "symmetric+energy",
             "asymmetric+sign_bug+av+balsara")
NAN_FIELDS = [(c, side, k) for c in NAN_CASES
              for side, n in (("source", len(SRC_NAMES) if "balsara" in c
                               else 9), ("target", len(_tgt_names(
                                   PASS2_CASES[c]))))
              for k in range(n)]


def _field_id(c, side, k):
    names = SRC_NAMES if side == "source" else _tgt_names(PASS2_CASES[c])
    return f"{c}-{side}-{names[k]}"


@pytest.mark.parametrize("value", [np.nan, np.inf], ids=["nan", "inf"])
@pytest.mark.parametrize("case,side,k", NAN_FIELDS,
                         ids=[_field_id(*f) for f in NAN_FIELDS])
def test_pass2_non_finite_field_reaches_as_in_the_plain_version(
        case, side, k, value):
    """One non-finite value in one staged row, at a live slot outside
    both supports of target 0 (at the origin, ih = 2; the slot at r = 5
    with ih 1), or in target 0's own column: the pairs pass2.cu visits
    give non-finite outputs exactly where the plain version does."""
    f = PASS2_CASES[case]
    nv, tgt, src, kw, pkw = _pass2_case(f, seed=5)
    g, b = src[0].shape[0], tgt[0].shape[0] // src[0].shape[0]
    gi = int(np.nonzero(nv > 16)[0][-1])
    src[0][gi, 14], src[1][gi, 14], src[2][gi, 14] = 5.0, 0.0, 0.0
    src[3][gi, 14], src[4][gi, 14] = 1.0, 1.0
    if side == "source":
        src[k][gi, 14] = value
    else:
        tgt[k][gi * b] = value
    ref, out, live, inside = _pass2_visited(nv, tgt, src, kw, pkw, f)
    assert len(src) == (9 if case == "symmetric+energy" else 13)
    if value is np.nan and side == "source" and SRC_NAMES[k] in ("m", "cc"):
        assert any(bool(torch.isnan(r).any()) for r in ref)
    _check_non_finite(out, ref, lambda o, r: _check_pass2(o, r, f))


P1_FIELDS = {"x": ("source", 0), "y": ("source", 1), "z": ("source", 2),
             "m": ("source", 3), "target x": ("target", 0),
             "target ih": ("target", 3)}


@pytest.mark.parametrize("value", [np.nan, np.inf], ids=["nan", "inf"])
@pytest.mark.parametrize("field", sorted(P1_FIELDS))
def test_pass1_non_finite_field_reaches_as_in_the_plain_version(field,
                                                                 value):
    """pass1_gradh the same way: a non-finite x, y, z or m at a live slot
    far outside the support of target 0, or in target 0's x or ih."""
    nv, tgt, src = _case(6)
    _plant_knife_edges(nv, tgt, src)
    gi = int(np.nonzero(nv > 16)[0][-1])
    src[0][gi, 14], src[1][gi, 14], src[2][gi, 14] = 5.0, 0.0, 0.0
    src[4][gi, 14] = 1.0
    rows = [src[0], src[1], src[2], src[4]]
    side, k = P1_FIELDS[field]
    if side == "source":
        rows[k][gi, 14] = value
    else:
        tgt[k][gi * B] = value
    nv, tgt, rows = torch.from_numpy(nv), _t(_cols(tgt)), _t(rows)
    below, r2, tih = _geometry(nv, tgt, rows)
    live = below & (rows[3][:, None, :] != 0.0)
    skip = torch.from_numpy(_skipped(r2.numpy(), tih.numpy(),
                                     _all_pairs(nv, tgt, rows, 3).numpy()))
    ref = tk.pass1_gradh_plain(nv, tgt, rows)
    out = tk.pass1_gradh_plain(*_visited(nv, rows, live & ~skip)[:1], tgt,
                               _visited(nv, rows, live & ~skip)[1])
    if value is np.nan and field == "m":
        assert bool(torch.isnan(ref[0]).any())

    def check(o, r):
        _close(o[1], r[1], 0)
        _close(o[0], r[0], 2e-6)
        _close(o[2], r[2], 1e-5, 1e-6 * float(r[2].abs().max()))
    _check_non_finite(out, ref, check)


def test_gravity_softening_propagates_a_nan_ih():
    """pass2.cu softens with psph_min (min.NaN.f32), NaN when either ih
    is, as the plain version's torch.minimum; the P2P windows of p2p.cu
    and gravity_fused.cu's near tier call the same."""
    nan = np.float32(np.nan)
    got = P2_SOFTENING(ih=np.array([1.0, nan, 2.0], np.float32),
                       jh=np.array([nan, 1.0, 3.0], np.float32))
    assert np.isnan(got[:2]).all() and got[2] == 2.0
    common = _source("common.cuh")
    assert "RECV ? ih[u] : psph_min(ih[u], jh)" in _source("p2p.cu")
    near = _source("gravity_fused.cu")
    assert "RECV ? ih : psph_min(ih, cih[j])" in near
    assert "RECV ? ih : psph_min(ih, cih[jb])" in near
    assert 'asm("min.NaN.f32' in common
    for name in ("common.cuh", "pass2.cu"):
        assert "fminf(ih" not in _source(name), name
    t = torch.tensor
    assert torch.isnan(torch.minimum(t([1.0]), t([float("nan")]))).all()


def test_the_r_guard_keeps_a_nan_r2():
    """Every gravity sweep guards r = 0 with rsqrtf(psph_max(r2, 1e-30f))
    or, where the bare instruction stands in for rsqrtf (past the floor
    no denormal is left to scale), psph_rsqrt_ftz(psph_max(r2, 1e-30f)):
    max.NaN.f32 keeps a NaN r2 (a NaN position) as the plain versions'
    torch.clamp does, where fmaxf would return 1e-30 and a finite
    potential; for every other r2 the two give the same bits. p2p.cu,
    gravity_fused.cu's near tier and pairwise_pass1.cu take it through
    psph_p2p_pair, the bf16 pairs through psph_bf_geometry; pairwise_pass1.cu's
    other 1/r, from its q^2 test's s2 = r2 ihm^2 without the guard,
    reaches only the pairs the test skips (s2 > 4: never 0, a denormal or
    NaN), through selects that give every other pair 0."""
    srcs = {n: _source(n) for n in sorted(os.listdir(CSRC))
            if n.endswith((".cu", ".cuh"))}
    for name, src in srcs.items():
        assert "fmaxf(r2" not in src, name
    guard = re.compile(r"(rsqrtf|psph_rsqrt_ftz)\(\s*psph_max\((r2|psph_r2_rn"
                       r"\([^)]*\)), 1e-30f\)\)")
    for name in ("common.cuh", "pass2.cu", "gravity_fused.cu"):
        assert guard.search(srcs[name]), name
    body = re.search(r"void psph_p2p_pair\(.*?\n}\n", srcs["common.cuh"],
                     re.S)
    assert body and guard.search(body.group(0))
    # in gravity_fused.cu every 1/r is guarded: the f32 and bf16 monopoles
    grav = re.sub(r"//[^\n]*", "", srcs["gravity_fused.cu"])
    assert len(guard.findall(grav)) == grav.count("rsqrt") == 2
    for name in ("p2p.cu", "pairwise_pass1.cu", "gravity_fused.cu"):
        assert "psph_p2p_pair(" in srcs[name], name
    # the bf16 pairs' geometry keeps the same guard
    geo = re.search(r"PsphBfPair psph_bf_geometry\(.*?\n}\n",
                    srcs["common.cuh"], re.S)
    assert geo and guard.search(geo.group(0))
    # the synchronous window sweep and the one-pair bf16 body are gone:
    # every gravity pair goes through the bodies above
    for name, src in srcs.items():
        assert "psph_p2p_window" not in src, name
        assert "psph_dyer_ip_bf16" not in src, name
    pw1 = srcs["pairwise_pass1.cu"]
    far = re.search(r"const bool skip = (s2 > PSPH_Q2_SKIP);", pw1)
    assert far and "const float inv_r = psph_rsqrt_ftz(s2) * ihm;" in pw1
    assert "const float mr = skip ? p.w * inv_r : 0.0f;" in pw1
    assert "const float mag = skip ? mr * inv_r * inv_r : 0.0f;" in pw1
    assert "rsqrtf(" not in re.sub(r"//[^\n]*", "", pw1)
    skipped = _c_test(far.group(1))
    s2 = np.array([0.0, np.nan, 1e-40, 4.0, 5.0, np.inf], np.float32)
    got = skipped(s2=s2, PSPH_Q2_SKIP=Q2_SKIP)
    assert got.tolist() == [False, False, False, False, True, True]
    nan = np.float32(np.nan)
    guard = _c_test("psph_max(r2, floor)")
    floor = np.float32(1e-30)
    assert np.isnan(guard(r2=nan, floor=floor))
    r2 = np.array([0.0, 1e-31, 1e-30, 2.5, np.inf], np.float32)
    np.testing.assert_array_equal(guard(r2=r2, floor=floor),
                                  np.fmax(r2, floor))
    t = torch.tensor([float("nan")])
    assert torch.isnan(torch.clamp(t, min=1e-30)).all()


def test_visited_rows_keep_slot_order():
    rows = [torch.arange(12, dtype=torch.float32).reshape(2, 6)]
    keep = torch.tensor([[[1, 0, 1, 0, 0, 1]], [[0, 0, 0, 0, 0, 0]]],
                        dtype=torch.bool)
    n, (r,) = _visited(torch.tensor([6, 6], dtype=torch.int32), rows, keep)
    assert n.tolist() == [3, 0] and r[0].tolist() == [0.0, 2.0, 5.0]


def test_cases_cover_both_windows_and_every_flag():
    """The cases above reach every form the kernel has: each pressure form,
    the sign bug, viscosity, Balsara, energy, both gravity forms and
    receiver softening."""
    fs = PASS2_CASES.values()
    assert {f["mode"] for f in fs} == set(tk.MODES)
    for key in ("sign_bug", "av", "balsara", "energy", "grav", "merged",
                "receiver"):
        assert any(f[key] for f in fs), key


def test_standing_nan_differences_of_the_other_kernels():
    """The all-pairs kernels keep a NaN where their plain versions do:
    pairwise_pass1 softens gravity with psph_min (NaN when either 1/h is,
    as torch.minimum), and both gate out a pair that passed the q^2 test
    only when r/h_i >= 2 and r/h_j >= 2 on the tile's gate ih, which the
    non-finite flags of the staged tile and of the target zero (then
    nothing is gated out), so a NaN in r or either 1/h is never gated
    out; a flagged target visits its self pair with m = 0 and counts it
    nowhere."""
    nan = np.float32(np.nan)
    pw1, pw2 = _source("pairwise_pass1.cu"), _source("pairwise_pass2.cu")
    assert "RECV ? ih[u] : psph_min(ih[u], jh)" in pw1
    assert "fminf(ih" not in pw1 and "fminf(ih" not in pw2
    gates = [re.search(r"if \(!\((__fmul_rn\(r, ih_tile\[u\]\) >= 2\.0f "
                       r"&& qj >= 2\.0f)\)\) \{", pw1),
             re.search(r"if \((r \* ih_tile\[u\] >= 2\.0f && qj >= 2\.0f)\) "
                       r"return;", pw2)]
    assert all(gates)
    for src in (pw1, pw2):
        assert "const bool tile_bad = __syncthreads_or(bad) != 0;" in src
        assert "bad = bad || !psph_all_finite(v);" in src
        assert "target_bad[u] = !psph_all_finite(own);" in src
        assert "const bool all_pairs = tile_bad || target_bad[u];" in src
        # one 1/h for the q^2 test and the gate: 0 for a flagged target
        assert "ih_tile[u] = all_pairs ? 0.0f : ih[u];" in src
        assert "const float ihm = psph_min(ih_tile[u], " in src
        # a self pair is listed only for a flagged target
        assert "(!self || target_bad[u])" in src
    # pass 2 stages its factor P/rho (P/rho^2) and tests it with the rows
    assert "v[5] = asymmetric ? prs[j] / rj : prs[j] / (rj * rj);" in pw2
    # the self pair weighs m = 0, and pass 1 counts it in neither count
    assert "const float m = self ? 0.0f : cm[k];" in pw2
    assert "near(u, jh, self ? 0.0f : p.w, dxx, dxy, dxz," in pw1
    assert "self ? 0 : 1);" in pw1
    assert "nn[u] += qi < 2.0f ? other : 0;" in pw1
    assert "pi[(size_t)n] = GRAV ? sources - (own ? 1 : 0) : 0;" in pw1
    for gate in gates:
        gated_out = _c_test(gate.group(1))
        ih_tile = _c_test("all_pairs ? 0.0f : ih")
        far = np.float32(1e3)
        for r, ih, jh in ((far, 1.0, nan), (far, nan, 1.0), (nan, 1.0, 1.0)):
            assert not gated_out(r=r, qj=np.float32(r) * np.float32(jh),
                                 ih_tile=ih_tile(all_pairs=False, ih=ih))
        assert gated_out(r=far, qj=far, ih_tile=ih_tile(all_pairs=False,
                                                        ih=1.0))
        assert not gated_out(r=far, qj=far, ih_tile=ih_tile(all_pairs=True,
                                                            ih=1.0))
    assert np.isnan(_c_test("psph_min(ih, jh)")(ih=1.0, jh=nan))


# ---------------------------------------------------------------------------
# the all-pairs kernels' q^2 test
# ---------------------------------------------------------------------------

def _pairwise_skips():
    """Each all-pairs kernel's q^2 test as its source states it: a
    function of the pair's d = x_i - x_j, both 1/h and the target's flag
    (tile or target not finite, which zeroes the test's 1/h_i) that says
    whether the pair is skipped."""
    out = {}
    for name, jh in (("pairwise_pass1.cu", "jh"), ("pairwise_pass2.cu",
                                                    "p.w")):
        src = _source(name)
        r2 = re.search(r"const float dxz = z\[u\] - p\.z;\s*"
                       r"const float r2 = ([^;]+);", src)
        ihm = re.search(r"const float ihm = (psph_min\(ih_tile\[u\], "
                        + re.escape(jh) + r"\));", src)
        tile = re.search(r"ih_tile\[u\] = ([^;]+);", src)
        if name == "pairwise_pass1.cu":
            m = re.search(r"const float s2 = ([^;]+);\s*"
                          r"const bool skip = (s2 > PSPH_Q2_SKIP);", src)
            test = m and m.group(2).replace("s2", f"({m.group(1)})")
        else:
            m = re.search(r"if \(!\((\(r2 \* ihm\) \* ihm > PSPH_Q2_SKIP)\) "
                          r"&&", src)
            test = m and m.group(1)
        assert r2 and ihm and tile and test, name
        f_r2, f_tile = _c_test(r2.group(1)), _c_test(tile.group(1))
        f_ihm = _c_test(ihm.group(1).replace(jh, "jh"))
        f_test = _c_test(test)

        def skipped(dx, dy, dz, ih, jh, flagged=False, f_r2=f_r2,
                    f_ihm=f_ihm, f_test=f_test, f_tile=f_tile):
            ih_tile = f_tile(all_pairs=np.asarray(flagged), ih=ih)
            return np.asarray(f_test(r2=f_r2(dxx=dx, dxy=dy, dxz=dz),
                                     ihm=f_ihm(ih_tile=ih_tile, jh=jh),
                                     PSPH_Q2_SKIP=Q2_SKIP))
        out[name] = skipped
    return out


PW_SKIPS = _pairwise_skips()


def _pw_knife_edges(rng, n, rel, log_lo=-3.0, log_hi=3.0):
    """n pairs at |r| = (2 / min(ih, jh)) rel (1 + k 2^-24), k in
    [-256, 256], in random directions: float32 components."""
    ih = (10.0 ** rng.uniform(log_lo, log_hi, n)).astype(np.float32)
    jh = (ih * 10.0 ** rng.uniform(-1, 1, n)).astype(np.float32)
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0)
    k = rng.integers(-256, 257, n)
    r = (2.0 / np.minimum(ih, jh).astype(np.float64)) * rel \
        * (1 + k * 2.0 ** -24)
    dx, dy, dz = ((r * c).astype(np.float32) for c in u)
    return dx, dy, dz, ih, jh


@pytest.mark.parametrize("scale", [(-3.0, 3.0), (-9.0, -6.0)],
                         ids=["code_units", "cgs"])
@pytest.mark.parametrize("rel", [1.0, float(np.sqrt(Q2_SKIP / 4.0))],
                         ids=["q_at_2", "at_the_skip_threshold"])
@pytest.mark.parametrize("kernel", sorted(PW_SKIPS))
def test_pairwise_skip_leaves_out_no_pair_inside_a_support(kernel, rel,
                                                           scale):
    """A pair the all-pairs kernels' q^2 test skips has sqrtf(r2) ih >= 2
    for both 1/h, r2 formed as the plain version forms it (separate
    float32 operations), at the knife edge r ih = 2 (1 +- k 2^-24) of the
    larger support and at the test's own threshold."""
    rng = np.random.default_rng(13)
    dx, dy, dz, ih, jh = _pw_knife_edges(rng, 400_000, rel, *scale)
    skip = PW_SKIPS[kernel](dx, dy, dz, ih, jh)
    r2 = _r2(dx, dy, dz)
    assert not np.any(skip & (_q(r2, ih) < 2.0))
    assert not np.any(skip & (_q(r2, jh) < 2.0))
    if rel == 1.0:
        assert not skip.any()          # q within 256 ulps of 2: all kept
    else:
        assert 0 < skip.sum() < skip.size   # both sides of the threshold


@settings(max_examples=300, deadline=None)
@given(log_ih=st.floats(-9.0, 3.0), log_ratio=st.floats(-2.0, 2.0),
       k=st.integers(-8, 8), ux=st.floats(-1.0, 1.0),
       uy=st.floats(-1.0, 1.0), uz=st.floats(-1.0, 1.0))
def test_pairwise_skip_property_at_the_knife_edge(log_ih, log_ratio, k, ux,
                                                  uy, uz):
    """r ih_min = 2 (1 + k 2^-23), k in [-8, 8]: a skipped pair is outside
    both supports, in both kernels."""
    norm = np.sqrt(ux * ux + uy * uy + uz * uz)
    if norm < 1e-3:
        ux, uy, uz, norm = 1.0, 0.0, 0.0, 1.0
    ih = np.float32(10.0 ** log_ih)
    jh = np.float32(10.0 ** (log_ih + log_ratio))
    r = (2.0 / float(min(ih, jh))) * (1 + k * 2.0 ** -23)
    dx, dy, dz = (np.float32(r * c / norm) for c in (ux, uy, uz))
    r2 = _r2(dx, dy, dz)
    for skipped in PW_SKIPS.values():
        if skipped(dx, dy, dz, ih, jh):
            assert _q(r2, ih) >= 2.0 and _q(r2, jh) >= 2.0


@pytest.mark.parametrize("kernel", sorted(PW_SKIPS))
def test_pairwise_skip_keeps_nan_zero_ih_and_flagged_pairs(kernel):
    """No pair with a NaN r2 (a NaN or infinite position: inf - inf) or a
    NaN 1/h is skipped, none with a zero 1/h (h = inf: ihm = 0), and none
    of a flagged tile or target (its zeroed ihm), an infinite r2
    included; a far pair of finite values is skipped."""
    skipped = PW_SKIPS[kernel]
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    f = np.float32
    far = f(1e3)
    # the last: an infinite x against itself or another, inf - inf
    dx = np.array([nan, far, far, far, far, nan], np.float32)
    ih = np.array([1.0, nan, 1.0, 0.0, 1.0, 1.0], np.float32)
    jh = np.array([1.0, 1.0, nan, 1.0, 0.0, 1.0], np.float32)
    zero = np.zeros_like(dx)
    assert not skipped(dx, zero, zero, ih, jh).any()
    assert skipped(far, f(0), f(0), f(1), f(1))
    assert skipped(inf, f(0), f(0), f(1), f(1))     # r2 = inf, unflagged
    for d in (far, inf, f(2.1)):
        assert not skipped(d, f(0), f(0), f(1), f(1), flagged=True)


# ---------------------------------------------------------------------------
# the all-pairs kernels' cull of far (warp, sub-tile) pairs under a plan
# ---------------------------------------------------------------------------

def _cull_tests():
    """common.cuh's box test (psph_gap, psph_box_far), the flag its boxes
    carry (psph_box_store) and PSPH_FAR_Q2, as the header states them,
    and each all-pairs sweep's use of it: a function far(alo, ahi, blo,
    bhi) of [4, ...] float32 arrays (x, y, z and 1/h: a box's lo.w)."""
    hdr = _source("common.cuh")
    gap = re.search(r"float psph_gap\([^)]*\) \{\s*return ([^;]+);", hdr)
    body = re.search(r"bool psph_box_far\(.*?\n}\n", hdr, re.S)
    const = re.search(r"#define\s+PSPH_FAR_Q2\s+([0-9.eE+-]+)f", hdr)
    assert gap and body and const, "the box test was not found"
    body = body.group(0)
    axes = re.findall(r"const float g([xyz]) = psph_gap\(alo\.\1, ahi\.\1, "
                      r"blo\.\1, bhi\.\1\);", body)
    d2 = re.search(r"const float d2 = ([^;]+);", body)
    ihm = re.search(r"const float ihm = psph_min\(alo\.w, blo\.w\);", body)
    far = re.search(r"return (\(d2 \* ihm\) \* ihm > PSPH_FAR_Q2 && "
                    r"d2 >= PSPH_R2_FLOOR);", body)
    floor = re.search(r"#define\s+PSPH_R2_FLOOR\s+([0-9.eE+-]+)f", hdr)
    assert axes == ["x", "y", "z"] and d2 and ihm and far and floor
    f_gap, f_d2, f_far = (_c_test(e.group(1)) for e in (gap, d2, far))
    far_q2 = np.float32(const.group(1))
    r2_floor = np.float32(floor.group(1))

    def box_far(alo, ahi, blo, bhi):
        g = [f_gap(alo=alo[c], ahi=ahi[c], blo=blo[c], bhi=bhi[c])
             for c in range(3)]
        d2 = f_d2(gx=g[0], gy=g[1], gz=g[2])
        with np.errstate(invalid="ignore"):
            m = np.minimum(np.asarray(alo[3], np.float32),
                           np.asarray(blo[3], np.float32))
        return np.asarray(f_far(d2=d2, ihm=m, PSPH_FAR_Q2=far_q2,
                                PSPH_R2_FLOOR=r2_floor))
    return box_far, far_q2, r2_floor


BOX_FAR, FAR_Q2, R2_FLOOR = _cull_tests()


def test_the_cull_is_the_sweeps_and_its_boxes_flag_non_finite_values():
    """Under a plan both sweeps take a sub-tile only when it is live and
    not far from the warp's own box; a far sub-tile is not staged by
    pass 2 nor by pass 1 without gravity, and pass 1 stages it without its
    1/h and sweeps it for gravity's outer branch alone. A staged
    sub-tile's flag is any of its staged values not finite, on any lane. A box is flagged (lo.w NaN) when a value
    a stage copies of one of its particles is not finite; both stage
    kernels test every value they copy (and pass 2 the factors P/rho,
    P/rho^2 the sweep forms). PSPH_FAR_Q2 lies above PSPH_Q2_SKIP."""
    assert FAR_Q2 > Q2_SKIP
    assert FAR_Q2 == np.float32(4.0) * (1 + np.float32(2.0) ** -10)
    hdr = _source("common.cuh")
    assert "const bool flagged = __any_sync(0xffffffffu, bad);" in hdr
    assert "const float ihm = flagged ? __int_as_float(0x7fc00000) : lo.w;" \
        in hdr
    assert np.isnan(np.array([0x7fc00000], np.uint32).view(np.float32)[0])
    for name in ("pairwise_pass1.cu", "pairwise_pass2.cu"):
        src = _source(name)
        assert ("const bool keep = live && !psph_box_far(tlo, thi, "
                "box[2 * sb],\n                                              "
                "box[2 * sb + 1]);") in src, name
        assert "const float4 tlo = box[2 * (wlo / PSPH_SUB)];" in src, name
        assert "const bool tile_bad = __any_sync(0xffffffffu, bad);" in src
        assert "psph_box_store(lo, hi, bad, box + 2 * (size_t)sub);" in src
    pw1, pw2 = _source("pairwise_pass1.cu"), _source("pairwise_pass2.cu")
    assert "bad = bad || !psph_all_finite(v);" in pw1
    assert "return psph_all_finite(v);" in pw2
    assert "if (!put(k, v)) bad = true;" in pw2
    assert "if (lane + 32 * t < cnt && !put(k0 + lane + 32 * t, v[t]))" in pw2
    assert "bad = bad || !psph_all_finite(v[t]);" in pw1
    assert "for (unsigned todo = GRAV ? lives : keeps; todo;" in pw1
    assert "for (unsigned todo = keeps; todo; todo &= todo - 1) {" in pw2
    assert "v[t][3] = far ? 1.0f : inv_h[j];" in pw1
    assert ("const float v[5] = {pos[3 * i], pos[3 * i + 1], "
            "pos[3 * i + 2],\n                        inv_h[i], mass[i]};"
            ) in pw1
    assert ("float v[14] = {pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], "
            "inv_h[i],\n                   mass[i], rj, prs[i],\n"
            "                   asymmetric ? prs[i] / rj : prs[i] / "
            "(rj * rj),\n                   prs[i] / (rj * rj),") in pw2
    assert "bad = bad || !isfinite(fb[i]);" in pw2
    # the far sweep: the outer branch's m/r and m/r^3 with the bare rsqrt
    # (a far box pair's r2 lies at or above the plain version's clamp)
    assert ("const float inv_r = psph_rsqrt_ftz(r2);\n"
            "              const float mr = p.w * inv_r;\n"
            "              const float mag = mr * inv_r * inv_r;") in pw1
    assert R2_FLOOR == np.float32(1e-30)


def _box_knife_edges(rng, n, rel, log_lo=-3.0, log_hi=3.0):
    """n box pairs whose closest corners lie (2 / ihm) rel (1 + k 2^-23)
    apart, k in [-300, 300], ihm the smaller of the boxes' 1/h, in random
    directions of random signs; the boxes' other corners up to 40 support
    radii away. Returns the boxes (lo, hi: [4, n], 1/h in lo[3]) and the
    two closest corners' (d, ih_i, jh) as float32."""
    ih = (10.0 ** rng.uniform(log_lo, log_hi, n)).astype(np.float32)
    jh = (ih * 10.0 ** rng.uniform(-1, 1, n)).astype(np.float32)
    u = np.abs(rng.normal(size=(3, n)))
    u /= np.linalg.norm(u, axis=0)
    k = rng.integers(-300, 301, n)
    ihm = np.minimum(ih, jh).astype(np.float64)
    g = (2.0 / ihm) * rel * (1 + k * 2.0 ** -23) * u
    sign = rng.choice([-1.0, 1.0], size=(3, n))
    # corner a of box A at c; B's corner at c + sign g; A extends away
    # from B and B away from A
    c = rng.uniform(-100, 100, size=(3, n)) / ihm
    ext_a = rng.uniform(0, 40, size=(3, n)) / ihm
    ext_b = rng.uniform(0, 40, size=(3, n)) / ihm
    a_near = c.astype(np.float32)
    b_near = (c + sign * g).astype(np.float32)
    a_far = (c - sign * ext_a).astype(np.float32)
    b_far = (c + sign * (g + ext_b)).astype(np.float32)
    alo, ahi = np.minimum(a_near, a_far), np.maximum(a_near, a_far)
    blo, bhi = np.minimum(b_near, b_far), np.maximum(b_near, b_far)
    alo = np.vstack([alo, ih[None]])
    blo = np.vstack([blo, jh[None]])
    d = a_near - b_near
    return (alo, ahi, blo, bhi), d, ih, jh


def _box_pairs(rng, boxes, ih, jh, m=8):
    """m more particle pairs of each box pair: one point drawn in each box
    (their 1/h at least the box's), and the two closest corners."""
    alo, ahi, blo, bhi = boxes
    out = []
    for _ in range(m):
        pa = (alo[:3] + rng.uniform(size=alo[:3].shape)
              * (ahi - alo[:3])).astype(np.float32)
        pb = (blo[:3] + rng.uniform(size=blo[:3].shape)
              * (bhi - blo[:3])).astype(np.float32)
        pa = np.clip(pa, alo[:3], ahi)
        pb = np.clip(pb, blo[:3], bhi)
        ih_p = (ih * rng.uniform(1, 3, ih.shape)).astype(np.float32)
        jh_p = (jh * rng.uniform(1, 3, jh.shape)).astype(np.float32)
        out.append((pa - pb, ih_p, jh_p))
    return out


@pytest.mark.parametrize("scale", [(-3.0, 3.0), (-9.0, -6.0)],
                         ids=["code_units", "cgs"])
@pytest.mark.parametrize("rel", [1.0, float(np.sqrt(FAR_Q2 / 4.0))],
                         ids=["q_at_2", "at_the_far_threshold"])
@pytest.mark.parametrize("kernel", sorted(PW_SKIPS))
def test_a_far_box_pair_holds_no_pair_the_q2_test_keeps(kernel, rel, scale):
    """At the knife edge of the boxes' gap (their closest corners 2/ihm
    rel (1 +- k 2^-23) apart), a box pair the cull calls far holds no
    pair that the kernel's q^2 test keeps, nor one with sqrtf(r2) ih < 2
    for either 1/h (r2 as the plain version forms it): neither the closest
    corners at the boxes' own 1/h nor points drawn inside the boxes at
    larger 1/h."""
    rng = np.random.default_rng(29)
    boxes, d, ih, jh = _box_knife_edges(rng, 200_000, rel, *scale)
    far = BOX_FAR(*boxes)
    for dd, ih_p, jh_p in [(d, ih, jh)] + _box_pairs(rng, boxes, ih, jh):
        kept = ~PW_SKIPS[kernel](dd[0], dd[1], dd[2], ih_p, jh_p)
        assert not np.any(far & kept)
        r2 = _r2(*dd)
        assert not np.any(far & (_q(r2, ih_p) < 2.0))
        assert not np.any(far & (_q(r2, jh_p) < 2.0))
        # the far sweep's r2 (its multiply-adds) needs no clamp
        assert not np.any(far & (_fmaf(dd[2], dd[2], _fmaf(
            dd[1], dd[1], dd[0] * dd[0])) < R2_FLOOR))
    if rel == 1.0:
        assert not far.any()            # gaps within 300 ulps of 2/ihm
    else:
        assert 0 < far.sum() < far.size  # both sides of the threshold


@settings(max_examples=300, deadline=None)
@given(log_ih=st.floats(-9.0, 3.0), log_ratio=st.floats(-2.0, 2.0),
       k=st.integers(-8, 8), ux=st.floats(0.0, 1.0), uy=st.floats(0.0, 1.0),
       uz=st.floats(0.0, 1.0), ext=st.floats(0.0, 50.0))
def test_a_far_box_pair_property_at_the_knife_edge(log_ih, log_ratio, k, ux,
                                                   uy, uz, ext):
    """Boxes whose closest corners lie 2 sqrt(PSPH_FAR_Q2 / 4) / ihm (1 +
    k 2^-23) apart, k in [-8, 8], each `ext` support radii deep: far only
    if the corners' pair is outside both supports and skipped by both
    kernels' q^2 tests."""
    norm = np.sqrt(ux * ux + uy * uy + uz * uz)
    if norm < 1e-3:
        ux, uy, uz, norm = 1.0, 0.0, 0.0, 1.0
    ih = np.float32(10.0 ** log_ih)
    jh = np.float32(10.0 ** (log_ih + log_ratio))
    ihm = float(min(ih, jh))
    r = (2.0 / ihm) * float(np.sqrt(FAR_Q2 / 4.0)) * (1 + k * 2.0 ** -23)
    g = np.array([ux, uy, uz]) / norm * r
    e = ext / ihm
    a_hi = np.zeros(3, np.float32)
    b_lo = g.astype(np.float32)
    alo = np.append(np.float32(-e) * np.ones(3, np.float32), ih)
    blo = np.append(b_lo, jh)
    bhi = (b_lo + np.float32(e)).astype(np.float32)
    two = lambda v: np.repeat(v[:, None], 2, axis=1)   # (no 0-d arrays)
    if BOX_FAR(two(alo), two(a_hi), two(blo), two(bhi))[0]:
        d = a_hi - b_lo
        r2 = _r2(*d)
        assert _q(r2, ih) >= 2.0 and _q(r2, jh) >= 2.0
        for skipped in PW_SKIPS.values():
            assert skipped(d[0], d[1], d[2], ih, jh)


def test_a_box_with_a_nan_or_a_flag_is_never_far():
    """A NaN in any bound of either box, or in either box's 1/h (a flagged
    box: psph_box_store writes NaN there), is never far, nor are
    overlapping or touching boxes, nor a box of zero 1/h (h = inf), nor
    boxes whose gap squared lies below PSPH_R2_FLOOR; a far pair of finite
    boxes is far."""
    nan, f = np.float32(np.nan), np.float32
    lo_a = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    hi_a = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    lo_b = np.array([100.0, 0.0, 0.0, 1.0], np.float32)
    hi_b = np.array([101.0, 1.0, 1.0, 0.0], np.float32)

    def far(la, ha, lb, hb):
        two = lambda v: np.repeat(v[:, None], 2, axis=1)
        return bool(BOX_FAR(two(la), two(ha[:3]), two(lb), two(hb[:3]))[0])
    assert far(lo_a, hi_a, lo_b, hi_b) and far(lo_b, hi_b, lo_a, hi_a)
    for box in ("a", "b"):
        for c in range(4):
            for which in ("lo", "hi"):
                if which == "hi" and c == 3:
                    continue
                la, ha, lb, hb = (v.copy() for v in (lo_a, hi_a, lo_b, hi_b))
                v = {("a", "lo"): la, ("a", "hi"): ha, ("b", "lo"): lb,
                     ("b", "hi"): hb}[(box, which)]
                v[c] = nan
                assert not far(la, ha, lb, hb), (box, which, c)
    # touching, overlapping, a zero 1/h
    lb = lo_b.copy()
    lb[0] = f(1.0)
    assert not far(lo_a, hi_a, lb, hi_b)
    lb[0] = f(-5.0)
    assert not far(lo_a, hi_a, lb, hi_b)
    lb = lo_b.copy()
    lb[3] = f(0.0)
    assert not far(lo_a, hi_a, lb, hi_b)
    # an infinite bound that is not flagged is far; the stage flags it
    hb = hi_b.copy()
    hb[0] = np.inf
    assert far(lo_a, hi_a, lo_b, hb)
    # a gap far beyond both supports, but its square below PSPH_R2_FLOOR
    la, ha = lo_a.copy(), hi_a.copy()
    lb, hb = lo_b.copy(), hi_b.copy()
    la[3] = lb[3] = f(1e18)
    ha[0] = f(0.0)
    lb[0], hb[0] = f(1e-16), f(1.0)
    assert not far(la, ha, lb, hb)
    lb[0] = f(1e-14)
    assert far(la, ha, lb, hb)


def _plain_boxes(pos, inv_h, perm, bad):
    """The plan's boxes as the stage kernels form them: the particles in
    the plan's order, PSPH_SUB a box, each box's bounds and least 1/h,
    NaN for a flagged box (`bad`: a particle with a non-finite value)."""
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    n = pos.shape[0]
    p = pos[perm].numpy()
    ih = inv_h[perm].numpy()
    b = bad[perm].numpy()
    nb = -(-n // pw.SUB)
    lo = np.zeros((4, nb), np.float32)
    hi = np.zeros((3, nb), np.float32)
    for k in range(nb):
        s = slice(k * pw.SUB, min(n, (k + 1) * pw.SUB))
        lo[:3, k], hi[:, k] = p[s].min(axis=0), p[s].max(axis=0)
        lo[3, k] = np.float32(np.nan) if b[s].any() else ih[s].min()
    return lo, hi


def _culled(pos, h, plan, cfg, bad=None):
    """[n, n] the pairs the sweeps visit under `plan`: the pairs of near
    box pairs (BOX_FAR on the plan's boxes, as the kernels form them)
    that the kernel's q^2 test keeps; and the far mask itself."""
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    n = pos.shape[0]
    inv_h = 1.0 / torch.where(h > 0, h, 1.0)
    if bad is None:
        bad = torch.zeros(n, dtype=torch.bool)
    lo, hi = _plain_boxes(pos, inv_h, plan.perm, bad)
    nb = lo.shape[1]
    far_box = BOX_FAR(lo[:, :, None], hi[:, :, None], lo[:, None, :],
                      hi[:, None, :])
    rank = torch.empty_like(plan.perm)
    rank[plan.perm] = torch.arange(n)
    cell = (rank // pw.SUB).numpy()
    far = far_box[cell[:, None], cell[None, :]]
    p = pos.numpy()
    d = p[:, None, :] - p[None, :, :]
    ih = inv_h.numpy()
    skipped = PW_SKIPS["pairwise_pass1.cu"](
        d[..., 0], d[..., 1], d[..., 2], ih[:, None], ih[None, :])
    assert nb == -(-n // pw.SUB)
    return ~far & ~skipped, far


def _ball(n, clustered, seed):
    """A seeded cold ball (uniform, radius 12, h 1.2 (1 + U[0, 0.5))) or a
    clustered one (two Gaussian clumps of unequal size and a uniform
    halo, h following the local spacing): float32 pos [n,3], h, m."""
    rng = np.random.default_rng(seed)
    if not clustered:
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1)[:, None]
        pos = u * 12.0 * rng.uniform(size=(n, 1)) ** (1 / 3)
        h = 1.2 * (1 + 0.5 * rng.uniform(size=n))
    else:
        a, b = n // 2, n // 4
        pos = np.concatenate([rng.normal(0.0, 1.5, (a, 3)),
                              rng.normal((30.0, 0.0, 0.0), 0.7, (b, 3)),
                              rng.uniform(-25, 25, (n - a - b, 3))])
        h = np.concatenate([np.full(a, 0.8), np.full(b, 0.45),
                            np.full(n - a - b, 3.5)]) \
            * (1 + 0.3 * rng.uniform(size=n))
    f = lambda v: torch.from_numpy(np.asarray(v, np.float32))
    return f(pos), f(h), f(rng.uniform(0.5, 1.5, n))


@pytest.mark.parametrize("clustered,n", [(False, 2000), (True, 1500)],
                         ids=["ball_2000", "clustered_1500"])
def test_pass1_on_the_culled_pairs_matches(clustered, n):
    """The plain pass 1 of each target over just the sources the cull and
    the q^2 test leave it (its own row of pass1_plain on [target,
    sources]) against pass1_plain over every pair: counts bit-equal,
    density within the tolerances of the all-pairs kernels. Every pair of
    a far box pair takes gravity's outer branch in the plain version (x =
    r / a >= 1 under both softenings), which the far sweep adds alone."""
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    pos, h, m = _ball(n, clustered, 5)
    plan = pw.plan(pos)
    cfg = tc.jupiter_3k(n=n, gravity_solver="none")
    visit, far = _culled(pos, h, plan, cfg)
    assert 0.1 < far.mean() < 0.95, far.mean()  # the cull engages
    ref = pw.pass1_plain(pos, h, m, cfg)
    rho, nn = np.zeros(n, np.float32), np.zeros(n, np.int32)
    for i in range(n):
        js = np.flatnonzero(visit[i] & (np.arange(n) != i))
        idx = torch.from_numpy(np.concatenate([[i], js]))
        out = pw.pass1_plain(pos[idx], h[idx], m[idx], cfg)
        rho[i], nn[i] = float(out.rho[0]), int(out.n_neighbors[0])
    np.testing.assert_array_equal(nn, ref.n_neighbors.numpy())
    assert nn.mean() > 10
    np.testing.assert_allclose(rho, ref.rho.numpy(), rtol=1e-5)
    # gravity's branch on the far pairs: x >= 1 under both softenings
    ih = (1.0 / h).numpy()
    p = pos.numpy()
    r = np.sqrt(_r2(*(p[:, None, :] - p[None, :, :]).transpose(2, 0, 1)))
    for inv_a in (ih[:, None] + 0 * ih[None, :],
                  np.minimum(ih[:, None], ih[None, :])):
        assert np.all((r * inv_a)[far] >= 1.0)


@pytest.mark.parametrize("case", ["symmetric", "asymmetric+sign_bug",
                                  "av+balsara"])
@pytest.mark.parametrize("clustered,n", [(False, 2000), (True, 1500)],
                         ids=["ball_2000", "clustered_1500"])
def test_pass2_on_the_culled_pairs_matches(case, clustered, n):
    """pass2_plain of each target over just the sources the cull and the
    q^2 test leave it against pass2_plain over every pair, within the
    tolerances of the all-pairs kernels (rtol 1e-4 and 1e-4 of the
    largest magnitude), in each form of the sweep."""
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    pos, h, m = _ball(n, clustered, 8)
    plan = pw.plan(pos)
    kw = dict(symmetric={}, **{
        "asymmetric+sign_bug": dict(grad_p_mode="reference_asymmetric",
                                    kernel_deriv_sign_bug=True),
        "av+balsara": dict(av_alpha=1.0, av_beta=2.0, av_balsara=True)})
    cfg = tc.jupiter_3k(n=n, **kw[case])
    visit, _ = _culled(pos, h, plan, cfg)
    rho = pw.pass1_plain(pos, h, m, cfg).rho
    prs = 1000.0 * rho * rho
    extra = {}
    if case == "av+balsara":
        rng = np.random.default_rng(2)
        extra = dict(vel=-0.05 * pos + torch.from_numpy(
            rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)),
            fbal=torch.from_numpy(rng.uniform(0.3, 1.0, n).astype(
                np.float32)))
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    ref = as_tuple(pw.pass2_plain(pos, h, m, rho, prs, cfg, **extra))
    got = [np.zeros_like(r.numpy()) for r in ref]
    for i in range(n):
        js = np.flatnonzero(visit[i] & (np.arange(n) != i))
        idx = torch.from_numpy(np.concatenate([[i], js]))
        sub = {k: v[idx] for k, v in extra.items()}
        out = as_tuple(pw.pass2_plain(pos[idx], h[idx], m[idx], rho[idx],
                                      prs[idx], cfg, **sub))
        for g, o in zip(got, out):
            g[i] = o[0].numpy()
    for g, r in zip(got, ref):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()))


def test_a_non_finite_value_flags_its_box_and_opens_it_to_every_warp():
    """A NaN (or infinity) in any value a stage copies of one particle
    flags that particle's box, which is then near every other box, so
    every target visits the particle's pairs under the kernels' all_pairs
    rule and the value reaches the outputs as in the plain version; the
    other boxes keep their far pairs."""
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    pos, h, m = _ball(2000, False, 3)
    plan = pw.plan(pos)
    cfg = tc.jupiter_3k(n=2000)
    j = 333
    bad = torch.zeros(2000, dtype=torch.bool)
    bad[j] = True
    _, far_clean = _culled(pos, h, plan, cfg)
    _, far = _culled(pos, h, plan, cfg, bad)
    assert far_clean[:, j].any() and not far[:, j].any()
    assert not far[j].any()
    # the rest keep their far pairs: only the flagged box's rows and
    # columns opened
    rank = torch.empty_like(plan.perm)
    rank[plan.perm] = torch.arange(2000)
    mine = (rank // pw.SUB == int(rank[j]) // pw.SUB).numpy()
    other = ~mine[:, None] & ~mine[None, :]
    np.testing.assert_array_equal(far[other], far_clean[other])


# ---------------------------------------------------------------------------
# pass1_sym: the either-support skip and the compaction of dead slots
# ---------------------------------------------------------------------------

def test_sym_skip_takes_the_larger_support():
    """pass1_sym.cu's skip compares with the smaller of the two ih (the
    larger h), its operands made >= 0 and not NaN, and the pair that is
    visited takes q = sqrtf(r2) ih and forms ih^3 once a slot."""
    src = _source("pass1_sym.cu")
    assert "const float ihm = fminf(ih_tile, p.w);" in src
    assert "const float q = r * ih;" in src and "sqrtf(r2)" in src
    assert "v[3] = jh * jh * jh;" in src
    # a pair inside only the larger support is never skipped
    r2 = np.float32(9.0)                    # r = 3
    assert not _sym_skipped(r2, np.float32(2.0), np.float32(0.5))
    assert not _sym_skipped(r2, np.float32(0.5), np.float32(2.0))
    assert _sym_skipped(r2, np.float32(2.0), np.float32(2.0))


def _sym_knife_edges(rng, n, rel, log_lo, log_hi):
    """n pairs at |r| = (2 / min(ih, jh)) rel (1 + k 2^-24), k in
    [-256, 256], in random directions; ih over [log_lo, log_hi] decades,
    jh within a decade of it either way."""
    ih = (10.0 ** rng.uniform(log_lo, log_hi, n)).astype(np.float32)
    jh = (ih * 10.0 ** rng.uniform(-1, 1, n)).astype(np.float32)
    u = rng.normal(size=(3, n))
    u /= np.linalg.norm(u, axis=0)
    k = rng.integers(-256, 257, n)
    r = (2.0 / np.minimum(ih, jh).astype(np.float64)) * rel \
        * (1 + k * 2.0 ** -24)
    dx, dy, dz = ((r * c).astype(np.float32) for c in u)
    return _r2(dx, dy, dz), ih, jh


@pytest.mark.parametrize("scale", [(-3.0, 3.0), (-9.0, -6.0)],
                         ids=["code_units", "cgs"])
@pytest.mark.parametrize("rel", [1.0, float(np.sqrt(Q2_SKIP / 4.0))],
                         ids=["q_at_2", "at_the_skip_threshold"])
def test_sym_skipped_pair_is_outside_both_supports_numpy(rel, scale):
    """A skipped pair has sqrtf(r2) ih >= 2 for both ih, on knife edges of
    the larger support, in code units and at cgs scale (h ~ 1e6-1e9)."""
    rng = np.random.default_rng(11)
    r2, ih, jh = _sym_knife_edges(rng, 400_000, rel, *scale)
    skip = _sym_skipped(r2, ih, jh)
    assert not np.any(skip & (_q(r2, ih) < 2.0))
    assert not np.any(skip & (_q(r2, jh) < 2.0))
    if rel == 1.0:
        assert not skip.any()          # q within 256 ulps of 2: all kept
    else:
        assert 0 < skip.sum() < skip.size   # both sides of the threshold


@settings(max_examples=300, deadline=None)
@given(log_ih=st.floats(-9.0, 3.0), log_ratio=st.floats(-2.0, 2.0),
       k=st.integers(-4096, 4096), ux=st.floats(-1.0, 1.0),
       uy=st.floats(-1.0, 1.0), uz=st.floats(-1.0, 1.0))
def test_sym_skipped_pair_is_outside_both_supports_property(
        log_ih, log_ratio, k, ux, uy, uz):
    norm = np.sqrt(ux * ux + uy * uy + uz * uz)
    if norm < 1e-3:
        ux, uy, uz, norm = 1.0, 0.0, 0.0, 1.0
    ih = np.float32(10.0 ** log_ih)
    jh = np.float32(10.0 ** (log_ih + log_ratio))
    r = (2.0 / float(min(ih, jh))) * (1 + k * 2.0 ** -24)
    dx, dy, dz = (np.float32(r * c / norm) for c in (ux, uy, uz))
    r2 = _r2(dx, dy, dz)
    if _sym_skipped(np.float32(r2), ih, jh):
        assert _q(r2, ih) >= 2.0 and _q(r2, jh) >= 2.0


def test_sym_nan_and_non_positive_ih_are_never_skipped():
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    far = np.float32(1e6)
    r2 = np.array([nan, far, far, far, far, far, far, inf, inf],
                  np.float32)
    ih = np.array([1.0, nan, 1.0, 0.0, 1.0, -5.0, 1.0, 0.0, 1.0],
                  np.float32)
    jh = np.array([1.0, 1.0, nan, 1.0, 0.0, 1.0, -5.0, 1.0, nan],
                  np.float32)
    assert not _sym_skipped(r2, ih, jh).any()
    # far pairs of positive ih are skipped, an infinite r2 too
    assert _sym_skipped(np.array([far, inf], np.float32),
                        np.array([1.0, 1.0], np.float32),
                        np.array([2.0, 1.0], np.float32)).all()
    # the flag skips nothing
    assert not _sym_skipped(far, np.float32(1.0), np.float32(1.0), True)


def test_compaction_keeps_a_dead_slot_with_a_non_finite_field():
    """pass1_sym.cu and p2p.cu keep every live slot, and a dead one (m = 0)
    only where a staged field (pass1_sym: or ih^3) is not finite, or, in
    p2p, where some target of the block has a non-finite column."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    m = np.array([1.0, -1.0, nan, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                 np.float32)
    x = np.array([0.5, 0.5, 0.5, 0.5, nan, inf, 0.5, 0.5, 0.5, 0.5],
                 np.float32)
    jh = np.array([2.0, 2.0, 2.0, 2.0, 2.0, 2.0, nan, -inf, 1e13, -1.0],
                  np.float32)
    y = z = np.zeros_like(x)
    sym = SYM_KEEP(m=m, v=_sym_fields(x, y, z, jh, m))
    # ih = 1e13 is finite, its cube is not: 0 * 0 * inf is NaN
    assert sym.tolist() == [True] * 3 + [False] + [True] * 5 + [False]
    for keep_all in (False, True):
        p2p = P2P_KEEP(m=m, keep_all=np.asarray(keep_all),
                       v=np.stack([x, y, z, jh]))
        assert p2p.tolist() == (
            [True] * 10 if keep_all
            else [True] * 3 + [False] + [True] * 4 + [False] * 2)
    # under receiver softening p2p stages no ih (the source has 0 there)
    assert "RECV ? 0.0f : st[3][j]" in _source("p2p.cu")


def _sym_visits(nv, tgt, rows):
    """[G, B, S] pairs pass1_sym.cu visits: slots below nv its compaction
    keeps (SYM_KEEP on its fields), not skipped unless the slot's tile
    (PSPH_TILE slots) holds a kept slot with a non-finite field or the
    target has a non-finite column (S_ALL_PAIRS)."""
    g, s = rows[0].shape
    b = tgt[0].shape[0] // g
    f = _sym_fields(*(r.numpy() for r in rows))
    below = (np.arange(s)[None, :] < nv.numpy()[:, None])
    kept = below & SYM_KEEP(m=rows[4].numpy(), v=f)
    bad = kept & ~np.isfinite(f).all(axis=0)
    pad = -s % TILE
    tile_bad = np.pad(bad, ((0, 0), (0, pad))).reshape(g, -1, TILE) \
        .any(axis=2).repeat(TILE, axis=1)[:, :s]
    target_bad = ~np.isfinite(np.stack([c.numpy().reshape(g, b)
                                        for c in tgt])).all(axis=0)
    flag = S_ALL_PAIRS(tile_bad=tile_bad[:, None, :],
                       target_bad=target_bad[:, :, None])
    _, r2, tih = _geometry(nv, tgt, rows)
    skip = _sym_skipped(r2.numpy(), tih.numpy(),
                        rows[3][:, None, :].numpy(), flag)
    return torch.from_numpy(kept[:, None, :] & ~skip), \
        torch.from_numpy(np.broadcast_to(below[:, None, :] &
                                         (rows[4].numpy() != 0)[:, None, :],
                                         skip.shape).copy())


def _check_sym(o, r):
    _close(o[1], r[1], 0)
    _close(o[0], r[0], 2e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pass1_sym_on_the_visited_pairs_matches(seed):
    nv, tgt, src = _case(seed)
    _plant_knife_edges(nv, tgt, src)
    nv, tgt, rows = torch.from_numpy(nv), _t(_cols(tgt)), _t(src)
    keep, live = _sym_visits(nv, tgt, rows)
    assert int((live & ~keep).sum()) > 0          # the skip leaves pairs out
    assert not bool((keep & ~live).any())         # no dead slot is kept
    ref = tk.pass1_sym_plain(nv, tgt, rows)
    out = tk.pass1_sym_plain(*_visited(nv, rows, keep)[:1], tgt,
                             _visited(nv, rows, keep)[1])
    _check_sym(out, ref)


# the plantings of the pass1_sym and p2p tests: name -> (where, row)
FAR_FIELDS = {"x": ("source", 0), "ih": ("source", 3), "m": ("source", 4),
              "dead x": ("dead", 0), "dead ih": ("dead", 3),
              "target x": ("target", 0), "target ih": ("target", 3)}


def _plant_far_slot(nv, tgt, src, field, value, fields, dead_m=0.0):
    """Slot 14 of the last group with more than 16 slots at r = 5 from
    target 0 (at the origin, ih = 2), ih 1, m 1 (dead: dead_m); then
    `value` in the named field (fields: name -> (side, row))."""
    gi = int(np.nonzero(nv > 16)[0][-1])
    b = tgt[0].shape[0] // src[0].shape[0]
    src[0][gi, 14], src[1][gi, 14], src[2][gi, 14] = 5.0, 0.0, 0.0
    src[3][gi, 14], src[-1][gi, 14] = 1.0, 1.0
    side, k = fields[field]
    if side == "dead":
        src[-1][gi, 14] = dead_m
    if side == "target":
        tgt[k][gi * b] = value
    else:
        src[k][gi, 14] = value
    return gi


@pytest.mark.parametrize("value", [np.nan, np.inf], ids=["nan", "inf"])
@pytest.mark.parametrize("field", sorted(FAR_FIELDS))
def test_pass1_sym_non_finite_field_reaches_as_in_the_plain_version(
        field, value):
    """pass1_sym the way pass1_gradh is held: a non-finite x, ih or m at a
    live slot far outside both supports of target 0, the same in x or ih
    of a dead slot there, or in target 0's x or ih: the pairs pass1_sym.cu
    visits give non-finite outputs exactly where the plain version does."""
    nv, tgt, src = _case(6)
    _plant_knife_edges(nv, tgt, src)
    _plant_far_slot(nv, tgt, src, field, value, FAR_FIELDS)
    nv, tgt, rows = torch.from_numpy(nv), _t(_cols(tgt)), _t(src)
    keep, _ = _sym_visits(nv, tgt, rows)
    ref = tk.pass1_sym_plain(nv, tgt, rows)
    nv1, rows1 = _visited(nv, rows, keep)
    out = tk.pass1_sym_plain(nv1, tgt, rows1)
    if field in ("m", "ih", "dead ih") and value is np.nan:
        assert bool(torch.isnan(ref[0]).any())
    _check_non_finite(out, ref, _check_sym)


def _p2p_visits(nv, tgt, rows, receiver):
    """[G, B, S] pairs p2p.cu visits: every pair of a slot below nv that
    its compaction keeps (P2P_KEEP on x, y, z[, ih]), with keep_all where
    some target of the group has a non-finite column."""
    g, s = rows[0].shape
    b = tgt[0].shape[0] // g
    below = np.arange(s)[None, :] < nv.numpy()[:, None]
    ih = np.zeros((g, s), np.float32) if receiver else rows[3].numpy()
    keep_all = ~np.isfinite(np.stack([c.numpy().reshape(g, b)
                                      for c in tgt])).all(axis=(0, 2))
    kept = below & P2P_KEEP(
        m=rows[-1].numpy(), keep_all=keep_all[:, None],
        v=np.stack([rows[0].numpy(), rows[1].numpy(), rows[2].numpy(), ih]))
    return torch.from_numpy(np.broadcast_to(kept[:, None, :],
                                            (g, b, s)).copy())


def _check_p2p(o, r):
    for k in range(4):
        _close(o[k], r[k], 1e-5, 1e-6 * float(r[k].abs().max()))
    _close(o[4], r[4], 0)


# receiver softening stages no source ih
P2P_PLANTINGS = [(f, r) for f in sorted(FAR_FIELDS) for r in (False, True)
                 if not (r and f in ("ih", "dead ih"))]


@pytest.mark.parametrize("value", [np.nan, np.inf], ids=["nan", "inf"])
@pytest.mark.parametrize("field,receiver", P2P_PLANTINGS,
                         ids=[f"{f}-{'receiver_h' if r else 'min_h'}"
                              for f, r in P2P_PLANTINGS])
def test_p2p_non_finite_field_reaches_as_in_the_plain_version(
        field, receiver, value):
    """p2p.cu evaluates every pair of the slots it keeps: a non-finite
    value at a live slot, at a dead one (m = 0) or in target 0's own
    column gives non-finite outputs exactly where the plain version over
    every slot below nv does."""
    nv, tgt, src = _case(7)
    _plant_far_slot(nv, tgt, src, field, value, FAR_FIELDS)
    if receiver:
        del src[3]
    nv, tgt, rows = torch.from_numpy(nv), _t(_cols(tgt)), _t(src)
    kw = dict(receiver_soft=receiver, g_const=0.7)
    keep = _p2p_visits(nv, tgt, rows, receiver)
    below = torch.arange(rows[0].shape[1])[None, :] < nv[:, None]
    assert bool((below & ~keep[:, 0, :]).any()) or field.startswith(
        "target")                                # dead slots left out
    ref = tk.p2p_plain(nv, tgt, rows, **kw)
    nv1, rows1 = _visited(nv, rows, keep)
    out = tk.p2p_plain(nv1, tgt, rows1, **kw)
    if field in ("dead x", "m") and value is np.nan:
        assert bool(torch.isnan(ref[0]).any())
    _check_non_finite(out, ref, _check_p2p)
