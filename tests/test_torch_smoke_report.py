"""What chip_smoke.py reports of the redesigned kernels, checked on the
CPU: the per-instance ``-Xptxas -v`` parse, the instance a pass-2 or
gravity_fused call launches, the shares of live slots and of pairs inside
the support, of far entries accepted and live, of filter slots kept and
pre-rejected with the boxes met and tests made, the bit comparison of two
launches, the planted-NaN check, the agreement ratios, the set of kernels
timed in turns and the routing of a kernel to another build; and the
script refuses to run without a card, with or without --parent."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from planetmodel_sph_tpu_torch.ops.cuda import build
from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
from test_torch_filter_prereject import _model, seeded_window
from test_torch_groups2 import B, _case, _cols, _grav_inputs, _t
from test_torch_groups2_modes import _pass2_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()

LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z12pass2_kernelILi0ELb0ELb1ELb1ELi2ELb0ELb1EEv9Pass2Args' for 'sm_90a'
ptxas info    : Function properties for _Z12pass2_kernelILi0ELb0ELb1ELb1ELi2ELb0ELb1EEv9Pass2Args
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 43264 bytes smem, 784 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12pass2_kernelILi2ELb0ELb0ELb0ELi0ELb0ELb0EEv9Pass2Args' for 'sm_90a'
ptxas info    : Function properties for _Z12pass2_kernelILi2ELb0ELb0ELb0ELi0ELb0ELb0EEv9Pass2Args
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, 20736 bytes smem, 784 bytes cmem[0]
"""


def test_ptxas_instances_parse_each_entry():
    a, b = cs.ptxas_instances(LOG)
    assert a["args"] == (0, 0, 1, 1, 2, 0, 1)
    assert (a["regs"], a["smem"], a["stack"], a["spill_stores"],
            a["spill_loads"]) == (64, 43264, 8, 4, 12)
    assert b["args"] == (2, 0, 0, 0, 0, 0, 0)
    assert (b["regs"], b["smem"], b["spill_stores"]) == (38, 20736, 0)
    p1 = cs.ptxas_instances(
        "ptxas info    : Compiling entry function '_Z18pass1_gradh_kernelPK"
        "fS0_S0_S0_S0_S0_S0_S0_PKiPfPiS3_iiii' for 'sm_90a'\n"
        "ptxas info    : Used 37 registers, 12544 bytes smem\n")
    assert p1[0]["args"] == () and p1[0]["regs"] == 37


def test_instance_key_follows_the_template_order():
    """pass2.cu's template parameters are MODE, SIGN_BUG, AV, BALSARA,
    GRAV, RECV, ENERGY; the key a call maps to follows them."""
    src = open(os.path.join(ROOT, "planetmodel_sph_tpu_torch", "csrc",
                            "pass2.cu")).read()
    assert re.search(r"template <int MODE, bool SIGN_BUG, bool AV, bool "
                     r"BALSARA, int GRAV,\s+bool RECV, bool ENERGY>", src)
    key = cs.instance_key
    assert key("pass2", dict(mode="grad_h", grav=True, p2p_rows=[0])) == \
        ("pass2", (0, 0, 0, 0, 2, 0, 0))
    assert key("pass2", dict(mode="symmetric", av=True, balsara=True,
                             energy=True, receiver_soft=True)) == \
        ("pass2", (2, 0, 1, 1, 0, 0, 1))
    assert key("pass2", dict(mode="reference_asymmetric", sign_bug=True,
                             grav=True, receiver_soft=True)) == \
        ("pass2", (1, 1, 0, 0, 1, 1, 0))
    assert key("pass1_gradh", {}) == ("pass1_gradh", ())
    assert key("pass1_sym", {}) == ("pass1_sym", ())
    assert key("p2p", dict(receiver_soft=True)) == ("p2p", (1,))
    assert key("p2p", dict(receiver_soft=False)) == ("p2p", (0,))
    # p2p.cu's one template parameter is RECV
    src = open(os.path.join(ROOT, "planetmodel_sph_tpu_torch", "csrc",
                            "p2p.cu")).read()
    assert "template <bool RECV>" in src


def _direct_shares(nv, tgt, src, pass1):
    """Shares counted pair by pair in numpy."""
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    m = src[3] if pass1 else src[4]
    below = live = live_pairs = inside = 0
    for gi in range(g):
        for j in range(min(int(nv[gi]), s)):
            below += 1
            if m[gi, j] == 0:
                continue
            live += 1
            for i in range(gi * b, gi * b + b):
                live_pairs += 1
                d = [tgt[k][i, 0] - src[k][gi, j] for k in range(3)]
                r2 = np.float32(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
                if pass1:
                    ins = np.sqrt(r2) * tgt[3][i, 0] < 2.0
                else:
                    r = np.sqrt(r2)
                    ins = r * min(tgt[3][i, 0], src[3][gi, j]) < 2.0
                inside += int(ins)
    return below, live, live_pairs, inside


@pytest.mark.parametrize("pass1", [True, False], ids=["pass1", "pass2"])
def test_window_shares_count_live_slots_and_pairs_inside(pass1):
    nv, tgt, src = _case(3)
    tgt = _cols(tgt)
    rows = [src[0], src[1], src[2], src[4]] if pass1 else src
    name = "pass1_gradh" if pass1 else "pass2"
    sh = cs.window_shares(name, (torch.from_numpy(nv), _t(tgt), _t(rows)),
                          {"b": B})
    below, live, live_pairs, inside = _direct_shares(nv, tgt, rows, pass1)
    assert (sh["slots_below_nv"], sh["live_slots"], sh["live_pairs"]) == \
        (below, live, live_pairs)
    # r from rsqrt in pass 2 may put a knife-edge pair on the other side
    assert abs(sh["pairs_inside"] - inside) <= (0 if pass1 else 2)
    assert 0 < sh["live_share"] < 1 and 0 < sh["inside_share"] < 1


def test_same_bits_tells_negative_zero_and_nan_apart():
    a = (torch.tensor([0.0, 1.0]), torch.tensor([3], dtype=torch.int32))
    assert cs.same_bits(a, tuple(t.clone() for t in a))
    assert not cs.same_bits(a, (torch.tensor([-0.0, 1.0]), a[1]))
    n = torch.tensor([float("nan")])
    assert cs.same_bits(n, n.clone())


def test_compacted_sweeps_are_the_redesigned_pair():
    assert set(cs.COMPACTED) == {"pass1_gradh", "pass1_sym", "pass2"}
    assert set(cs.COMPACTED) <= set(gk2.KERNELS)


@pytest.mark.parametrize("pass1", [True, False], ids=["pass1", "pass2"])
def test_nan_agreement_plants_nans_that_reach_the_outputs(pass1):
    """On the CPU the wrappers run their plain versions, so the check
    must pass, and the planted NaNs must reach an output."""
    if pass1:
        nv, tgt, src = _case(3)
        tgt, rows, kw = _cols(tgt), [src[0], src[1], src[2], src[4]], {}
    else:
        # the production form: grad-h, gravity with the merged P2P window
        nv, tgt, rows, pkw = _pass2_inputs(3, "grad_h", False, False, True,
                                           False)
        kw = dict(mode="grad_h", grav=True,
                  nv_p2p=torch.from_numpy(pkw["nv_p2p"]),
                  p2p_rows=_t(pkw["p2p_rows"]))
    name = "pass1_gradh" if pass1 else "pass2"
    a = (torch.from_numpy(nv), tuple(_t(tgt)), tuple(_t(rows)))
    msg, reached = cs.nan_agreement(name, a, dict(kw, b=B))
    assert msg is None
    # every field the check plants (x with a target ih and m in pass 1;
    # ih, m and cc in pass 2) reaches an output of the plain version
    assert set(reached) == ({"x+ih", "m"} if pass1 else {"ih", "m", "cc"})
    assert all(reached.values())
    # the inputs themselves are left as they were
    assert all(bool(torch.isfinite(t).all()) for t in a[1] + a[2])


def test_agreement_ratios_are_over_the_limit():
    from planetmodel_sph_tpu_torch.state import FIELDS

    class S:
        pass
    a, b = S(), S()
    for k in FIELDS:
        setattr(a, k, torch.zeros(3))
        setattr(b, k, torch.zeros(3))
    a.n_neighbors = torch.tensor([1, 5, 2], dtype=torch.int32)
    b.n_neighbors = torch.tensor([1, 2, 2], dtype=torch.int32)
    a.pos = torch.tensor([1.0, 0.0, 1.0 + 4e-5])
    b.pos = torch.tensor([1.0, 0.0, 1.0])
    r = cs.agreement_ratios(a, b)
    assert r["n_neighbors"] == 3.0 and r["vel"] == 0.0
    assert r["pos"] == pytest.approx((float(a.pos[2]) - 1.0) / (1e-6 + 2e-5))


def test_the_redesigned_kernels_are_timed_in_turns():
    """--parent builds and times these in turns with this checkout's; each
    case of them prints what it visits and holds two launches to the same
    bits; the filter's planted NaNs are checked with the others."""
    assert cs.REDESIGNED == ("pass1_gradh", "pass1_sym", "pass2",
                             "gravity_fused", "filter_sph", "p2p")
    assert set(cs.REDESIGNED) <= set(gk2.KERNELS)
    assert set(cs.REDESIGNED) == set(cs.NAN_CHECKED)
    # the all-pairs kernels are timed in turns too (their NaN repair)
    assert cs.ALL_PAIRS == ("pairwise_pass1", "pairwise_pass2")


def test_instance_key_of_gravity_fused():
    """gravity_fused.cu's template parameters are HAS_P2P (0 none, 1 min-h,
    2 receiver softening) and NM, the moment fields of the rows."""
    src = open(os.path.join(ROOT, "planetmodel_sph_tpu_torch", "csrc",
                            "gravity_fused.cu")).read()
    assert "template <int HAS_P2P, int NM>" in src
    a4, a10 = (None, None, [0] * 4), (None, None, [0] * 10)
    assert cs.instance_key("gravity_fused", {}, a10) == \
        ("gravity_fused", (0, 10))
    assert cs.instance_key("gravity_fused", dict(p2p_rows=[0]), a4) == \
        ("gravity_fused", (1, 4))
    assert cs.instance_key("gravity_fused", dict(
        p2p_rows=[0], receiver_soft=True), a10) == ("gravity_fused", (2, 10))
    assert cs.instance_key("filter_sph", {}, None) == ("filter_sph", ())


@pytest.mark.parametrize("blk", [False, True], ids=["far_only", "blk"])
def test_gravity_shares_count_live_entries(blk):
    """Far entries with accept > 0.5 and m > 0 among all (group, entry)
    slots; ring (and blk) slots below nv with m > 0: counted by hand."""
    nv, tgt, ring, far, acc = _grav_inputs(1, 10)
    kw = {"b": B}
    if blk:
        nv_blk = np.maximum(nv - 5, 0).astype(np.int32)
        kw.update(nv_blk=torch.from_numpy(nv_blk), blk_rows=_t(ring))
    a = (torch.from_numpy(nv), _t(tgt), _t(ring), _t(far),
         torch.from_numpy(acc))
    sh = cs.window_shares("gravity_fused", a, kw)
    g, nbpad = acc.shape
    far_live = sum(int(acc[gi, e] > 0.5 and far[0][0, e] > 0.0)
                   for gi in range(g) for e in range(nbpad))
    assert (sh["far_entries"], sh["far_live"]) == (g * nbpad, far_live)
    assert sh["far_live_share"] == pytest.approx(far_live / (g * nbpad))
    for key, n_w in (("ring", nv), ("blk", nv_blk if blk else None)):
        if n_w is None:
            assert "blk_live" not in sh
            continue
        below = sum(min(int(n), ring[0].shape[1]) for n in n_w)
        live = sum(int(ring[0][gi, j] > 0.0) for gi in range(g)
                   for j in range(min(int(n_w[gi]), ring[0].shape[1])))
        assert (sh[f"{key}_slots_below_nv"], sh[f"{key}_live"]) == \
            (below, live)
    assert 0 < sh["far_live_share"] < 1 and sh["ring_live_share"] < 1


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_shares_follow_the_kernels_decision(seed):
    """chip_smoke's model of filter_sph.cu's decision (what phase 4 prints)
    against the numpy model that evaluates the source's own expressions:
    live slots, kept, pre-rejected whole, boxes whose targets are tested
    and exact tests made, summed over the window; and the tests the bound
    charges (each live slot tests every target up to its first hit),
    counted slot by slot."""
    b = 64
    nv, tgt, src, _ = seeded_window(seed, b=b)
    keep, pre, live, boxes, tests = _model(nv, tgt, src, b)
    sh = cs.window_shares("filter_sph", (torch.from_numpy(nv), _t(tgt),
                                         _t(src)), {"b": b})
    assert (sh["live_slots"], sh["kept"], sh["prerejected"], sh["tests"]) \
        == (live.sum(), keep.sum(), pre.sum(), tests.sum())
    assert sh["boxes_tested"] == pytest.approx(boxes.sum() / live.sum())
    charged = 0
    g, s = src[0].shape
    for gi in range(g):
        for j in np.nonzero(live[gi])[0]:
            for i in range(b):
                t = [c[gi * b + i, 0] for c in tgt]
                d = [np.float32(t[k] - src[k][gi, j]) for k in range(3)]
                r2 = np.float32(np.float32(d[0] * d[0] + d[1] * d[1])
                                + d[2] * d[2])
                cut = np.float32(np.float32(max(t[3], src[3][gi, j])
                                            + t[4]) + src[4][gi, j])
                if r2 < np.float32(cut * cut):
                    charged += i + 1
                    break
            else:
                charged += b
    assert sh["charged_per_live"] == pytest.approx(charged / live.sum())
    assert sh["tests"] < 0.5 * charged
    line = cs.visits_line("filter_sph", dict(shares=sh, ptxas=None,
                                             same_bits=True))
    assert "pre-rejected whole" in line and "bit-identical" in line


def test_nan_agreement_of_the_filter_and_gravity():
    """On the CPU the wrappers run their plain versions, so the checks must
    pass: every filter planting (x, sc, ssk, m at a kept slot; tc, tsk in
    every target of its group) changes the planted group's mask, and
    gravity_fused plants m and ih."""
    nv, tgt, src, _ = seeded_window(0, b=64)
    a = (torch.from_numpy(nv), tuple(_t(tgt)), tuple(_t(src)))
    msg, reached = cs.nan_agreement("filter_sph", a, {"b": 64})
    assert msg is None
    assert reached == dict.fromkeys(("x", "sc", "ssk", "m", "tc", "tsk"),
                                    True)
    assert all(bool(torch.isfinite(t).all()) for t in a[1] + a[2])
    nv, tgt, ring, far, acc = _grav_inputs(2, 10)
    a = (torch.from_numpy(nv), tuple(_t(tgt)), tuple(_t(ring)),
         tuple(_t(far)), torch.from_numpy(acc))
    msg, reached = cs.nan_agreement("gravity_fused", a, {"b": B})
    assert msg is None and set(reached) == {"m", "ih"}


def test_library_routes_a_kernel_and_restores_it(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name, path: (name, path))
    monkeypatch.setattr(build, "_LIBS", {"pass2": "this"})
    with build.library("pass2", "/x/libpass2.so"):
        with build.library("pass1_gradh", "/x/libpass1_gradh.so"):
            assert build._LIBS == {
                "pass2": ("pass2", "/x/libpass2.so"),
                "pass1_gradh": ("pass1_gradh", "/x/libpass1_gradh.so")}
        assert "pass1_gradh" not in build._LIBS
    assert build._LIBS == {"pass2": "this"}
    assert build.lib_path("pass2", "/y") == os.path.join("/y", "libpass2.so")


@pytest.mark.parametrize("argv", [[], ["--parent", "elsewhere"]],
                         ids=["plain", "parent"])
def test_chip_smoke_refuses_without_a_card(monkeypatch, capsys, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main(argv) != 0
    assert capsys.readouterr().out == ""


def test_window_shares_of_pass1_sym_and_p2p():
    """pass1_sym: live slots, pairs inside either support (r min(ih_i,
    ih_j) < 2) and pairs its skip leaves out, counted pair by pair; p2p:
    the live share, every live pair evaluated."""
    nv, tgt, src = _case(4)
    tgt = _cols(tgt)
    a = (torch.from_numpy(nv), _t(tgt), _t(src))
    sh = cs.window_shares("pass1_sym", a, {"b": B})
    below, live, live_pairs, inside = _direct_shares(nv, tgt, src, False)
    q2 = np.float32(cs._cu_define("pass1_gradh", "PSPH_Q2_SKIP",
                                  "common.cuh"))
    skipped = 0
    for gi in range(src[0].shape[0]):
        for j in range(min(int(nv[gi]), src[0].shape[1])):
            if src[4][gi, j] == 0:
                continue
            for i in range(gi * B, gi * B + B):
                d = [np.float32(tgt[k][i, 0] - src[k][gi, j])
                     for k in range(3)]
                r2 = np.float32(np.float32(d[0] * d[0] + d[1] * d[1])
                                + d[2] * d[2])
                ihm = np.float32(min(tgt[3][i, 0], src[3][gi, j]))
                skipped += int(np.float32(r2 * ihm) * ihm > q2)
    assert (sh["slots_below_nv"], sh["live_slots"], sh["live_pairs"]) == \
        (below, live, live_pairs)
    assert abs(sh["pairs_inside"] - inside) <= 2    # sqrt here, rsqrt there
    assert sh["pairs_skipped"] == skipped
    assert 0 < skipped <= live_pairs - sh["pairs_inside"]
    line = cs.visits_line("pass1_sym", dict(shares=sh, ptxas=None,
                                            same_bits=True))
    assert "either support" in line and "skipped" in line
    p = cs.window_shares("p2p", a, {"b": B, "receiver_soft": False})
    assert (p["slots_below_nv"], p["live_slots"], p["live_pairs"]) == \
        (below, live, live_pairs) and "pairs_inside" not in p
    assert "every one of" in cs.visits_line(
        "p2p", dict(shares=p, ptxas=None, same_bits=True))


@pytest.mark.parametrize("name,receiver", [("pass1_sym", False),
                                           ("p2p", False), ("p2p", True)],
                         ids=["pass1_sym", "p2p-min_h", "p2p-receiver_h"])
def test_nan_agreement_of_pass1_sym_and_p2p(name, receiver):
    """On the CPU the wrappers run their plain versions, so the check must
    pass; pass1_sym's plantings (x with a target ih, ih, m, a dead slot's
    x and ih) and p2p's (m, ih under min-h softening, a dead slot's x and,
    under min-h, ih) reach an output where they must."""
    nv, tgt, src = _case(5)
    rows = list(src)
    kw = {"b": B}
    if name == "p2p":
        kw.update(receiver_soft=receiver, g_const=0.7)
        if receiver:
            del rows[3]
    a = (torch.from_numpy(nv), tuple(_t(_cols(tgt))), tuple(_t(rows)))
    msg, reached = cs.nan_agreement(name, a, kw)
    assert msg is None
    if name == "pass1_sym":
        assert reached == {"x+ih": True, "ih": True, "m": True,
                           "dead x": False, "dead ih": True}
    else:
        # a NaN ih meets the plain version's far branch, where only a pair
        # at r = 0 (inv_r = 1e15, cubed to inf) turns it into NaN
        labels = {"m", "dead x"} | ({"ih", "dead ih"} if not receiver
                                    else set())
        assert set(reached) == labels
        assert reached["m"] and reached["dead x"]
    assert all(bool(torch.isfinite(t).all()) for t in a[1] + a[2])


@pytest.mark.parametrize("name", ["pairwise_pass1", "pairwise_pass2"])
def test_pairwise_nan_agreement_plants_nans_that_reach(name):
    """The all-pairs plantings (x, m; pass 2 also P and, with viscosity
    and the Balsara sums, the velocity) on 64 particles: on the CPU the
    wrappers run their plain versions, so the check passes, and each
    planting reaches an output where it must."""
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    rng = np.random.default_rng(3)
    n = 64
    pos = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    h = torch.full((n,), 0.3)
    mass = torch.full((n,), 1.0 / n)
    kernel, plain = ((pw.pass1, pw.pass1_plain) if name == "pairwise_pass1"
                     else (pw.pass2, pw.pass2_plain))
    if name == "pairwise_pass1":
        cfg = tc.jupiter_3k(n=n)
        args, kw = (pos, h, mass), {}
        want = {"x": True, "m": True}
    else:
        cfg = tc.jupiter_3k(n=n, av_alpha=1.0, av_beta=2.0, av_balsara=True)
        args = (pos, h, mass, torch.full((n,), 2.0), torch.full((n,), 0.5))
        kw = dict(vel=-0.1 * pos, fbal=torch.ones(n))
        want = {"x": True, "m": True, "P": True, "velocity": True}
    msg, reached = cs.pairwise_nan_agreement(name, kernel, plain, args, kw,
                                             cfg)
    assert msg is None and reached == want
    assert all(bool(torch.isfinite(t).all()) for t in args)
