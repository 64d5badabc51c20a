"""What ``csrc/filter_sph.cu`` keeps exact when it leaves out tests.

The filter meets a slot first with the bounding box of each run of
PSPH_FILTER_BOX targets (with the box's largest tc and tsk): when the
slot's squared distance to the box is at least the box's squared cut
times PSPH_FILTER_MARGIN, none of the box's targets is tested (the
pre-reject). The targets of every other box take the exact test, as the
plain version does, in order to the first hit. The CUDA kernel runs only
on the card; here its expressions are read from the source and evaluated
on numpy float32 arrays without FMA (``test_torch_pair_skip._c_test``;
the library is built with -fmad=false), and held

- at knife edges and as a hypothesis property, to never pre-reject a slot
  that some target of the box keeps;
- to never pre-reject on a NaN, an infinity or a negative cut term;
- as the kernel's two-step decision (pre-reject, then the exact test) on
  seeded windows with planted knife edges, to the plain version's mask bit
  for bit;
- with a NaN in tc, sc, tsk or ssk, to drop the pair as the plain version's
  torch.maximum does (the cut takes psph_max, max.NaN.f32).
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from planetmodel_sph_tpu_torch.ops.cuda import groups2 as tk
from test_torch_pair_skip import _c_test, _source

SRC = _source("filter_sph.cu")
NAN, INF = np.float32(np.nan), np.float32(np.inf)


def _define(name):
    m = re.search(rf"#define\s+{name}\s+([0-9.eE+-]+)f?\b", SRC)
    assert m, f"{name} not found in filter_sph.cu"
    return m.group(1)


BOX = int(_define("PSPH_FILTER_BOX"))
MARGIN = np.float32(_define("PSPH_FILTER_MARGIN"))


def _members(expr):
    """One line, with C member access (lo.x) as a name (lo_x)."""
    return re.sub(r"\b([A-Za-z_]\w*)\.([xyzw])\b", r"\1_\2",
                  " ".join(expr.split()))


def _text(pattern):
    m = re.search(pattern, SRC, re.S | re.M)
    assert m, f"not found in filter_sph.cu: {pattern}"
    return _members(m.group(1))


def _args(text):
    """The top-level arguments of a call's argument list, each as a C
    expression evaluated by _c_test."""
    out, depth, cur = [], 0, ""
    for ch in text:
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
            continue
        depth += (ch == "(") - (ch == ")")
        cur += ch
    return [_c_test(a) for a in out + [cur]]


# the box of a run of targets: lo and hi each as make_float4's four
# arguments, the finiteness flag and the NaN it leaves in lo.w
LO = _args(_text(r"^\s*lo = make_float4\((.*?)\);"))
HI = _args(_text(r"^\s*hi = make_float4\((.*?)\);"))
FINITE = _c_test(_text(r"^\s*finite = (finite && .*?);"))
# the slot against a box
SC_PRE = _c_test(_text(r"const float sc_pre = (.*?);"))
GAP = {a: _c_test(_text(rf"const float e{a} = (.*?);")) for a in "xyz"}
D2 = _c_test(_text(r"const float d2 = (.*?);"))
CUT_MAX = _c_test(_text(r"const float cut_max = (.*?);"))
REJECT_TEXT = _text(r"if \(!\((d2 >= .*?)\)\) boxes \|= 1u << q;")
REJECT = _c_test(REJECT_TEXT)
# the exact test
DX = {a: _c_test(_text(rf"const float dx{a} = (.*?);")) for a in "xyz"}
R2 = _c_test(_text(r"const float r2 = (.*?);"))
CUT_TEXT = _text(r"const float cut = (.*?);")
CUT = _c_test(CUT_TEXT)
HIT = _c_test(_text(r"return (r2 < .*?);"))


def _box(tx, ty, tz, tc, tsk):
    """(lo, hi) of one run of targets as filter_sph.cu builds them: dicts
    over x, y, z, w (lo w: the largest tc, NaN unless every field of every
    target is finite and no cut term negative; hi w: the largest tsk)."""
    lo = dict(x=INF, y=INF, z=INF, w=-INF)
    hi = dict(x=-INF, y=-INF, z=-INF, w=-INF)
    finite = True
    for i in range(len(tx)):
        env = dict(p_x=tx[i], p_y=ty[i], p_z=tz[i], p_w=tc[i], tk=tsk[i],
                   **{f"lo_{k}": v for k, v in lo.items()},
                   **{f"hi_{k}": v for k, v in hi.items()})
        lo = {k: f(**env) for k, f in zip("xyzw", LO)}
        hi = {k: f(**env) for k, f in zip("xyzw", HI)}
        finite = bool(FINITE(finite=finite, **env))
    if not finite:
        lo["w"] = NAN
    return lo, hi


def _rejected(lo, hi, cx, cy, cz, cc, csk):
    """filter_sph.cu's pre-reject of slots (arrays) against one box."""
    sc_pre = SC_PRE(cx=cx, cy=cy, cz=cz, cc=cc, csk=csk, PSPH_NAN=NAN)
    gap = {a: GAP[a](**{f"lo_{a}": lo[a], f"hi_{a}": hi[a], f"c{a}": c})
           for a, c in zip("xyz", (cx, cy, cz))}
    d2 = D2(ex=gap["x"], ey=gap["y"], ez=gap["z"])
    cut_max = CUT_MAX(lo_w=lo["w"], sc_pre=sc_pre, hi_w=hi["w"], csk=csk)
    return REJECT(d2=d2, cut_max=cut_max, PSPH_FILTER_MARGIN=MARGIN)


def _hit(tx, ty, tz, tc, tsk, cx, cy, cz, cc, csk):
    """The exact test of one target against slots (arrays)."""
    d = {a: DX[a](**{f"p_{a}": t, f"c{a}": c})
         for a, t, c in zip("xyz", (tx, ty, tz), (cx, cy, cz))}
    r2 = R2(dxx=d["x"], dxy=d["y"], dxz=d["z"])
    return HIT(r2=r2, cut=CUT(p_w=tc, cc=cc, tk=tsk, csk=csk))


def _model(nv, tgt, src, b):
    """The kernel's two-step decision for every slot: (keep [G, S],
    pre-rejected by every box [G, S], live [G, S], boxes whose targets are
    tested [G, S], exact tests made [G, S]). A live slot meets every box;
    each box that does not pre-reject it has its targets tested in order,
    to the first hit."""
    g, s = src[0].shape
    keep, pre, live = (np.zeros((g, s), bool) for _ in range(3))
    boxes, tests = np.zeros((g, s), np.int64), np.zeros((g, s), np.int64)
    for gi in range(g):
        t = [c[gi * b:(gi + 1) * b, 0] for c in tgt]
        cx, cy, cz, cc, csk, m = (r[gi] for r in src)
        live[gi] = (np.arange(s) < min(int(nv[gi]), s)) & (m > 0.0)
        out, every = np.zeros(s, bool), np.ones(s, bool)
        for i0 in range(0, b, BOX):
            run = [c[i0:i0 + BOX] for c in t]
            rej = _rejected(*_box(*run), cx, cy, cz, cc, csk)
            every &= rej
            tested = live[gi] & ~rej
            boxes[gi] += tested
            hit = np.zeros(s, bool)
            for i in range(len(run[0])):
                tests[gi] += tested & ~hit
                hit |= tested & _hit(*(c[i] for c in run), cx, cy, cz, cc,
                                     csk)
            out |= hit
        keep[gi], pre[gi] = out, live[gi] & every
    return keep, pre, live, boxes, tests


def test_margin_and_the_kernels_expressions():
    """The margin lies just above 1 (far above the rounding of the box
    test's few operations, far below what would weaken it); the pre-reject
    is a >= compare, false for NaN; the exact cut takes psph_max, not
    fmaxf, and boxes split the targets of a group."""
    assert np.float32(1.0) < MARGIN < np.float32(1.01)
    assert MARGIN > np.float32(1.0) + 64 * np.finfo(np.float32).eps
    assert REJECT_TEXT == "d2 >= cut_max * cut_max * PSPH_FILTER_MARGIN"
    assert "if (!(d2 >= cut_max * cut_max * PSPH_FILTER_MARGIN))" in SRC
    assert "psph_max" in CUT_TEXT and "fmaxf" not in CUT_TEXT
    assert "if (!finite) lo.w = PSPH_NAN;" in SRC
    assert 1 < BOX < 64 and 64 % BOX == 0


@pytest.mark.parametrize("rel", [1.0 - 2.0 ** -20, 1.0, 1.0 + 2.0 ** -20,
                                 float(np.sqrt(MARGIN)) * (1 - 2.0 ** -20),
                                 float(np.sqrt(MARGIN)),
                                 float(np.sqrt(MARGIN)) * (1 + 2.0 ** -20)])
@pytest.mark.parametrize("run", [1, BOX], ids=["one_target", "full_box"])
def test_a_prerejected_slot_has_no_hit_at_knife_edges(rel, run):
    """Slots at rel times the box's cut from the box face along x, along
    a diagonal and at a corner: wherever the pre-reject fires, no target
    of the box keeps the slot; it never fires at or inside the cut, and it
    does fire a few ulp beyond cut sqrt(margin)."""
    rng = np.random.default_rng(run)
    t = [rng.uniform(0.0, 0.25, run).astype(np.float32) for _ in range(3)]
    t[0][0] = 0.25                   # a target on the box's +x face
    tc = rng.uniform(0.05, 0.3, run).astype(np.float32)
    tsk = rng.uniform(0.0, 0.02, run).astype(np.float32)
    tc[0], tsk[0] = 0.3, 0.02        # that target has the largest cut
    lo, hi = _box(*t, tc, tsk)
    cc = np.float32(0.1)
    csk = np.float32(0.01)
    cut_max = np.float32(np.float32(max(0.3, cc) + 0.02) + csk)
    d = np.float32(cut_max * np.float32(rel))
    dirs = [(1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0)]
    for u in dirs:
        u = np.asarray(u, np.float32) / np.float32(np.sqrt(sum(u)))
        c = [np.float32(hi[a] + d * u[k]) if u[k] else np.float32(t[k][0])
             for k, a in enumerate("xyz")]
        rej = bool(_rejected(lo, hi, *c, cc, csk))
        hits = [bool(_hit(t[0][i], t[1][i], t[2][i], tc[i], tsk[i], *c, cc,
                          csk)) for i in range(run)]
        assert not (rej and any(hits))
        if rel <= 1.0:
            assert not rej
        if rel > np.sqrt(MARGIN) * (1 + 2.0 ** -21):
            assert rej


@settings(max_examples=300, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), axes=st.integers(1, 7),
       k=st.integers(-64, 64), log_scale=st.floats(-3.0, 3.0),
       skin=st.booleans())
def test_a_prerejected_slot_has_no_hit_property(seed, axes, k, log_scale,
                                                skin):
    """A box of BOX random targets and a slot outside it, on one to three
    axes, at k float32 ulps around the pre-reject's edge: when the
    pre-reject fires, no target's exact test keeps the slot."""
    rng = np.random.default_rng(seed)
    scale = np.float32(10.0 ** log_scale)
    t = [(rng.uniform(0.0, 1.0, BOX) * scale).astype(np.float32)
         for _ in range(3)]
    tc = (rng.uniform(0.05, 0.5, BOX) * scale).astype(np.float32)
    tsk = ((rng.uniform(0.0, 0.05, BOX) if skin else np.zeros(BOX))
           * scale).astype(np.float32)
    lo, hi = _box(*t, tc, tsk)
    cc = np.float32(rng.uniform(0.05, 0.5) * scale)
    csk = np.float32(rng.uniform(0.0, 0.05) * scale) if skin \
        else np.float32(0.0)
    cut_max = CUT_MAX(lo_w=lo["w"], sc_pre=cc, hi_w=hi["w"], csk=csk)
    edge = np.float32(np.sqrt(np.float64(cut_max) ** 2 * float(MARGIN)))
    on = [bool(axes >> a & 1) for a in range(3)]
    d = np.float32(edge / np.float32(np.sqrt(sum(on))))
    d = np.float32(d * np.float32(1.0 + k * 2.0 ** -23))
    c = []
    for a, name in enumerate("xyz"):
        if on[a]:
            c.append(np.float32(hi[name] + d) if rng.uniform() < 0.5
                     else np.float32(lo[name] - d))
        else:
            c.append(np.float32(rng.uniform(float(lo[name]),
                                            float(hi[name]))))
    if not _rejected(lo, hi, *c, cc, csk):
        return
    for i in range(BOX):
        assert not _hit(t[0][i], t[1][i], t[2][i], tc[i], tsk[i], *c, cc,
                        csk)


_PLANT = [("cx", NAN), ("cx", INF), ("cx", -INF), ("cy", NAN),
          ("cz", INF), ("cc", NAN), ("cc", INF), ("cc", -1.0),
          ("csk", NAN), ("csk", INF), ("csk", -1.0), ("tx", NAN),
          ("tx", -INF), ("ty", INF), ("tz", NAN), ("tc", NAN),
          ("tc", INF), ("tc", -1.0), ("tsk", NAN), ("tsk", INF),
          ("tsk", -1.0)]


@pytest.mark.parametrize("field,value", _PLANT,
                         ids=[f"{f}={v}" for f, v in _PLANT])
def test_non_finite_or_negative_operands_are_never_prerejected(field,
                                                               value):
    """A slot far outside the box is pre-rejected; with a NaN, an
    infinity or a negative cut term in one of its fields, or in one field
    of one target of the box, it is not: it meets the exact tests."""
    rng = np.random.default_rng(7)
    t = {a: rng.uniform(0.0, 1.0, BOX).astype(np.float32)
         for a in ("tx", "ty", "tz")}
    t["tc"] = rng.uniform(0.05, 0.2, BOX).astype(np.float32)
    t["tsk"] = rng.uniform(0.0, 0.02, BOX).astype(np.float32)
    slot = dict(cx=np.float32(40.0), cy=np.float32(0.5), cz=np.float32(0.5),
                cc=np.float32(0.1), csk=np.float32(0.01))

    def rejected():
        lo, hi = _box(t["tx"], t["ty"], t["tz"], t["tc"], t["tsk"])
        return bool(_rejected(lo, hi, **slot))

    assert rejected()
    if field in slot:
        slot[field] = np.float32(value)
    else:
        t[field] = t[field].copy()
        t[field][3] = value
    assert not rejected()


def seeded_window(seed, g=3, b=64, s=512):
    """(nv, target columns, source rows, the knife-edge slots) of a seeded
    window: per group b targets in runs of BOX, each run its own small
    cluster, slots around them, padding (m = 0) and slots past nv; knife
    edges planted at r = cut (+- 2 ulp) of run 0's target with the largest
    x (its cut made the run's largest), and at the pre-reject's own edge
    of run 1 (slots 20-24, beyond its +y face)."""
    rng = np.random.default_rng(seed)
    runs = b // BOX
    corners = np.array([[-1, -1, 0], [1, -1, 0], [-1, 1, 0], [1, 1, 0],
                        [0, 0, 1], [0, 0, -1], [1, 0, 1], [-1, 0, -1]],
                       np.float32)[:runs] * 0.6
    centres = corners[None] + rng.uniform(-0.05, 0.05, (g, runs, 3))
    tpos = (np.repeat(centres, BOX, axis=1)
            + rng.uniform(-0.08, 0.08, (g, b, 3))).astype(np.float32)
    tc = rng.uniform(0.08, 0.16, (g, b)).astype(np.float32)
    tsk = rng.uniform(0.0, 0.01, (g, b)).astype(np.float32)
    spos = rng.uniform(-1.0, 1.0, (g, s, 3)).astype(np.float32)
    sc = rng.uniform(0.08, 0.16, (g, s)).astype(np.float32)
    ssk = rng.uniform(0.0, 0.01, (g, s)).astype(np.float32)
    sm = rng.uniform(0.5, 1.5, (g, s)).astype(np.float32)
    sm[:, 5::7] = 0.0
    edge_slots = np.arange(10, 15)
    for gi in range(g):
        i = int(np.argmax(tpos[gi, :BOX, 0]))
        tc[gi, i], tsk[gi, i] = 0.16, 0.01
        for j, kk in zip(edge_slots, range(-2, 3)):
            cut = np.float32(np.float32(max(tc[gi, i], sc[gi, j])
                                        + tsk[gi, i]) + ssk[gi, j])
            spos[gi, j] = tpos[gi, i]
            spos[gi, j, 0] = np.float32(
                tpos[gi, i, 0] + cut * np.float32(1.0 + kk * 2.0 ** -23))
        run = slice(BOX, 2 * BOX)
        lo, hi = _box(tpos[gi, run, 0], tpos[gi, run, 1], tpos[gi, run, 2],
                      tc[gi, run], tsk[gi, run])
        for j, kk in zip(range(20, 25), range(-2, 3)):
            cut_max = CUT_MAX(lo_w=lo["w"], sc_pre=sc[gi, j], hi_w=hi["w"],
                              csk=ssk[gi, j])
            edge = np.float32(np.sqrt(np.float64(cut_max) ** 2
                                      * float(MARGIN)))
            spos[gi, j] = [(lo["x"] + hi["x"]) / 2, hi["y"] + edge
                           * np.float32(1.0 + kk * 2.0 ** -23),
                           (lo["z"] + hi["z"]) / 2]
    nv = np.array([s // 2 + 3, s, s - 40][:g], np.int32)
    tgt = [np.ascontiguousarray(c.reshape(-1, 1), np.float32)
           for c in (tpos[..., 0], tpos[..., 1], tpos[..., 2], tc, tsk)]
    src = [np.ascontiguousarray(r, np.float32)
           for r in (spos[..., 0], spos[..., 1], spos[..., 2], sc, ssk, sm)]
    return nv, tgt, src, edge_slots


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_step_decision_matches_the_plain_filter(seed):
    """On seeded windows with planted knife edges (seeded_window) the
    kernel's decision, pre-reject then exact test, equals filter_sph_plain
    bit for bit, and the pre-reject fires on a real share of the live
    slots."""
    b = 64
    nv, tgt, src, edge_slots = seeded_window(seed, b=b)
    keep, pre, live, _, _ = _model(nv, tgt, src, b)
    ref = tk.filter_sph_plain(torch.from_numpy(nv),
                              [torch.from_numpy(c) for c in tgt],
                              [torch.from_numpy(r) for r in src]).numpy()
    np.testing.assert_array_equal(keep.astype(np.float32), ref)
    assert 0 < keep.sum() < live.sum()
    assert pre.sum() > 0.2 * live.sum()
    assert not (pre & keep).any()
    # the planted r = cut edges fall on both sides
    edges = keep[:, edge_slots]
    assert edges[:, 0].all() and not edges[:, -1].any()


@pytest.mark.parametrize("field", ["tc", "sc", "tsk", "ssk"])
def test_filter_cut_propagates_a_nan(field):
    """Repaired (was a standing difference, ROADMAP Queue C): filter_sph.cu
    takes the cut's max with psph_max (max.NaN.f32), so a NaN in tc, sc,
    tsk or ssk makes the cut NaN and the pair fails r2 < cut^2 even at
    r = 0, as the plain version's torch.maximum does; fmaxf would have kept
    the other operand."""
    env = dict(p_w=np.float32(0.5), cc=np.float32(0.4), tk=np.float32(0.01),
               csk=np.float32(0.02))
    env[{"tc": "p_w", "sc": "cc", "tsk": "tk", "ssk": "csk"}[field]] = NAN
    cut = CUT(**env)
    assert np.isnan(cut)
    assert not HIT(r2=np.float32(0.0), cut=cut)
    assert _c_test("fmaxf(a, c)")(a=NAN, c=1.0) == 1.0
    t = {k: torch.tensor([[float(v)]]) for k, v in env.items()}
    cut_t = torch.maximum(t["p_w"], t["cc"]) + t["tk"] + t["csk"]
    assert torch.isnan(cut_t).all()
    # the whole plain filter: one target, one slot at r = 0
    cols = [torch.zeros((1, 1)), torch.zeros((1, 1)), torch.zeros((1, 1)),
            t["p_w"], t["tk"]]
    rows = [torch.zeros((1, 1)), torch.zeros((1, 1)), torch.zeros((1, 1)),
            t["cc"], t["csk"], torch.ones((1, 1))]
    keep = tk.filter_sph_plain(torch.tensor([1], dtype=torch.int32), cols,
                               rows)
    assert keep.item() == 0.0
