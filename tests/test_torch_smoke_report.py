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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch thread: torch.sqrt on the CPU is MKL's vector math,
    which picks its code path at its first call in a process, and a first
    call made from several threads at once (a tensor torch splits, here
    the [3, 8, 256] pairs) has computed one thread's share on another
    path (2,045 of 6,144 square roots differed from a second call, in 3
    of 352 fresh processes on a loaded 8-core host), enough to move a
    count at the planted q = 2 pairs. A call on one thread takes one
    path."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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
    assert key("p2p", dict(receiver_soft=True)) == ("p2p", (1, 0))
    assert key("p2p", dict(receiver_soft=False)) == ("p2p", (0, 0))
    assert key("p2p", dict(receiver_soft=False, bf16=True)) == \
        ("p2p", (0, 1))
    # p2p.cu's template parameters are RECV and BF16
    src = open(os.path.join(ROOT, "planetmodel_sph_tpu_torch", "csrc",
                            "p2p.cu")).read()
    assert "template <bool RECV, bool BF16>" in src


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
    2 receiver softening), NM, the moment fields of the rows, and BF16."""
    src = open(os.path.join(ROOT, "planetmodel_sph_tpu_torch", "csrc",
                            "gravity_fused.cu")).read()
    assert "template <int HAS_P2P, int NM, bool BF16>" in src
    a4, a10 = (None, None, [0] * 4), (None, None, [0] * 10)
    assert cs.instance_key("gravity_fused", {}, a10) == \
        ("gravity_fused", (0, 10, 0))
    assert cs.instance_key("gravity_fused", dict(p2p_rows=[0]), a4) == \
        ("gravity_fused", (1, 4, 0))
    assert cs.instance_key("gravity_fused", dict(
        p2p_rows=[0], receiver_soft=True), a10) == \
        ("gravity_fused", (2, 10, 0))
    assert cs.instance_key("gravity_fused", dict(bf16=True), a10) == \
        ("gravity_fused", (0, 10, 1))
    # filter_sph.cu's template parameters: WIDE, more than 32 boxes of 16
    # targets a block, and TILED, 0 on the one-block path (b up to
    # FILTER_MAX_GROUP)
    fsrc = open(os.path.join(ROOT, "planetmodel_sph_tpu_torch", "csrc",
                             "filter_sph.cu")).read()
    assert "template <bool WIDE, bool TILED = false>" in fsrc
    assert cs.instance_key("filter_sph", {"b": 512}, None) == \
        ("filter_sph", (0, 0))
    assert cs.instance_key("filter_sph", {"b": 1024}, None) == \
        ("filter_sph", (1, 0))
    assert cs.instance_key("filter_sph", {"b": gk2.FILTER_MAX_GROUP},
                           None) == ("filter_sph", (1, 0))


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


@pytest.mark.parametrize("receiver", [False, True],
                         ids=["min_h", "receiver_h"])
def test_nan_agreement_plants_the_near_tiers_dead_slot(receiver):
    """With a near tier gravity_fused also plants NaNs in a dead slot (m =
    0) of its P2P window, which the near tier's compaction must keep: a
    NaN x reaches the plain version's outputs (m/r = 0 x NaN), a NaN ih
    (min-h softening only) gives x = NaN, the outer branch and m/r = 0,
    and is reported masked."""
    nv, tgt, ring, far, acc = _grav_inputs(2, 4)
    nvp, _, src = _case(2)
    prow = [src[0], src[1], src[2], src[4]] if receiver else src
    a = (torch.from_numpy(nv), tuple(_t(tgt)), tuple(_t(ring)),
         tuple(_t(far)), torch.from_numpy(acc))
    kw = dict(b=B, nv_p2p=torch.from_numpy(nvp), p2p_rows=_t(prow),
              receiver_soft=receiver)
    msg, reached = cs.nan_agreement("gravity_fused", a, kw)
    assert msg is None
    assert set(reached) == {"m", "ih", "dead near x"} | (
        set() if receiver else {"dead near ih"})
    assert reached["m"] and reached["dead near x"]
    assert not reached.get("dead near ih", False)
    assert all(bool(torch.isfinite(t).all()) for t in kw["p2p_rows"])


def test_library_routes_a_kernel_and_restores_it(monkeypatch):
    monkeypatch.setattr(build, "load",
                        lambda name, path, sig=None: (name, path))
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
    """The all-pairs plantings at two particles, the last and a third of
    the way in (a NaN and a +inf x, a NaN h, m; pass 2 also P and, with
    viscosity and the Balsara sums, the velocity) on 64 particles: on the
    CPU the wrappers run their plain versions, so the check passes, and
    each planting reaches an output where it must (a NaN h never: the
    wrappers' guard makes it 1)."""
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    rng = np.random.default_rng(3)
    n = 64
    pos = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    h = torch.full((n,), 0.3)
    mass = torch.full((n,), 1.0 / n)
    kernel, plain = ((pw.pass1, pw.pass1_plain) if name == "pairwise_pass1"
                     else (pw.pass2, pw.pass2_plain))
    fields = {"x": True, "x+inf": True, "h": False, "m": True}
    if name == "pairwise_pass1":
        cfg = tc.jupiter_3k(n=n)
        args, kw = (pos, h, mass), {}
    else:
        cfg = tc.jupiter_3k(n=n, av_alpha=1.0, av_beta=2.0, av_balsara=True)
        args = (pos, h, mass, torch.full((n,), 2.0), torch.full((n,), 0.5))
        kw = dict(vel=-0.1 * pos, fbal=torch.ones(n))
        fields.update(P=True, velocity=True)
    want = {f"{f}@{j}": v for j in (n - 1, n // 3) for f, v in fields.items()}
    msg, reached = cs.pairwise_nan_agreement(name, kernel, plain, args, kw,
                                             cfg)
    assert msg is None and reached == want
    assert all(bool(torch.isfinite(t).all()) for t in args)


def test_sass_pair_loops_counts_the_innermost_sweep_loops():
    """Two instances: an in-range loop (two MUFU.RSQ in 9 instructions)
    inside an outer tile loop, and an exact one that calls the square
    root's slow path (one MUFU.RSQ in 6)."""
    line = "        /*{:04x}*/                   {} ;"
    def fn(name, body):
        return [f"\t\tFunction : {name}"] + [line.format(16 * k, t)
                                             for k, t in enumerate(body)]
    a = fn("kernelA", ["MOV R1, R2", "LDS.128 R4, [R0]", "MUFU.RSQ R5, R4",
                       "FMUL R6, R5, R4", "MUFU.RSQ R7, R4", "FADD R8, R6,"
                       " R7", "ISETP.GE.AND P0, PT, R1, R2, PT",
                       "IADD3 R1, R1, 0x1, RZ", "FADD R9, R8, R9",
                       "@!P0 BRA 0x10", "BAR.SYNC.DEFER_BLOCKING 0x0",
                       "@!P1 BRA 0x0", "EXIT"])
    b = fn("kernelB", ["MUFU.RSQ R1, R2", "@P0 BRA 0x40",
                       "CALL.REL.NOINC 0x100", "FMUL R3, R1, R1",
                       "ISETP.NE.AND P1, PT, R3, RZ, PT", "@P1 BRA 0x0",
                       "EXIT"])
    got = cs.sass_pair_loops("\n".join(a + b))
    assert got == {"kernelA": [(4.5, False)], "kernelB": [(6.0, True)]}


# ---- phase 8: the long horizon --------------------------------------------

PHASE8 = os.path.join(ROOT, "tests", "chip_smoke_phase8_report.json")


def _phase8():
    import json
    with open(PHASE8) as f:
        return json.load(f)


def test_phase8_recorded_report_passes():
    """Phase 8's keys in a report recorded on the card: every run, its
    launches and the kernels it must launch, the ship gate's numbers, the
    rotating body's summary, the equilibrium artifacts, the bench lines,
    the served frame and the overlay's filter launch."""
    rep = _phase8()
    assert set(rep["runs"]) == {"drift100k", "rotating_l_check",
                                "equilibrium_run", "drift_probe",
                                "bench_lines", "cli", "cli_blocks"}
    assert cs.long_horizon_failures(rep) == []
    d = rep["runs"]["drift100k"]
    assert cs.failed_gates(d["gate"]) == []
    assert d["gate_line"].startswith("SHIP GATE [PASS]")
    assert set(d["phases"]) == {"settle", "drift"}
    assert set(rep["runs"]["drift100k"]["expect_launched"]) == \
        set(cs.LONG_KERNELS)
    assert [ln["metric"] for ln in rep["runs"]["bench_lines"]["lines"]] == [
        "particle_steps_per_sec_n3000", "particle_steps_per_sec_n100000"]


def _spoil(rep, path, value):
    *head, last = path
    d = rep
    for k in head:
        d = d[k]
    d[last] = value


@pytest.mark.parametrize("path,value,word", [
    (("runs", "drift100k", "gate", "energy_per_10k"), 2e-3, "|dE|/|E|"),
    (("runs", "drift100k", "gate", "spin_per_10k"), 1e-4, "dL/I"),
    (("runs", "drift100k", "gate", "overflow"), 3, "overflow"),
    (("runs", "drift100k", "gate"), None, "drift rows"),
    (("runs", "drift100k", "rc"), 2, "exit code 2"),
    (("runs", "rotating_l_check", "launches", "filter_sph"), 0,
     "no launch of ['filter_sph']"),
    (("runs", "rotating_l_check", "summary", "overflow"), 12,
     "rotating_l_check: overflow 12"),
    (("runs", "rotating_l_check", "summary", "energy_drift_per_10k"),
     float("nan"), "rotating_l_check"),
    (("runs", "equilibrium_run", "png_non_black"), 0.1, "PNG lit"),
    (("runs", "equilibrium_run", "missing"), ["equilibrium.png"],
     "missing"),
    (("runs", "drift_probe", "rc"), 1, "drift_probe: exit code 1"),
    (("runs", "bench_lines", "lines", 1, "error"), "boom", "bench --lines"),
    (("runs", "bench_lines", "lines", 0, "value"), 0.0, "bench --lines"),
    (("runs", "cli", "points_n"), 12, "phase 8 cli"),
    (("runs", "cli", "diag"), None, "phase 8 cli"),
    (("runs", "cli_blocks", "launches", "filter_sph"), 2, "filter_sph 2"),
], ids=lambda v: str(v)[:24])
def test_phase8_failures_name_what_failed(path, value, word):
    rep = _phase8()
    _spoil(rep, path, value)
    fails = cs.long_horizon_failures(rep)
    assert any(word in f for f in fails), fails


def test_phase8_reads_the_drift_tools_lines():
    out = ("step 500 [settle]: E=-125.228 ...\n"
           "phase settle: 2000 steps in 12.257 s of stepping = 163.173 "
           "steps/s; retried chunks 2.905 s\n"
           "phase drift: 10000 steps in 25.951 s of stepping = 385.341 "
           "steps/s; retried chunks 0.000 s\n")
    assert cs._phase_rates(out) == {
        "settle": dict(steps=2000, s=12.257, steps_per_s=163.173,
                       retried_s=2.905),
        "drift": dict(steps=10000, s=25.951, steps_per_s=385.341,
                      retried_s=0.0)}


def test_png_non_black_share(tmp_path):
    from PIL import Image
    a = np.zeros((10, 10, 3), np.uint8)
    a[:3] = 200
    Image.fromarray(a).save(tmp_path / "x.png")
    assert cs.png_non_black(str(tmp_path / "x.png")) == pytest.approx(0.3)


# ---- phase 9: the replicated data-parallel path ----------------------------

PHASE9 = os.path.join(ROOT, "tests", "chip_smoke_phase9_report.json")


def _phase9():
    import json
    with open(PHASE9) as f:
        return json.load(f)


def test_phase9_recorded_report_passes():
    """Phase 9's keys in a report recorded on the card: the three legs
    (world size 1 over NCCL, 2 and 4 ranks sharing the card over gloo),
    each rank's launches the single path's, G != NB on the shared-card
    legs, the four kernels held against their plain versions there, and
    the command line's two runs."""
    rep = _phase9()
    assert cs.dp_failures(rep) == []
    legs = rep["legs"]
    assert [(k, legs[k]["ranks"], legs[k]["backend"]) for k in legs] == [
        ("dp1", 1, "nccl"), ("dp2", 2, "gloo"), ("dp4", 4, "gloo")]
    assert legs["dp1"]["groups"] == legs["dp1"]["blocks"]
    assert legs["dp4"]["groups"] < legs["dp2"]["groups"] \
        < legs["dp2"]["blocks"]
    for leg in legs.values():
        assert leg["launches"] == {k: leg["ranks"] * v for k, v in
                                   rep["single"]["launches"].items()}
    assert {(c["name"], c["legs"][0]) for c in rep["cases"]} == {
        (n, leg) for n in cs.LONG_KERNELS for leg in ("dp2", "dp4")}


@pytest.mark.parametrize("path,value,word", [
    (("legs", "dp1", "error"), "RuntimeError: boom", "phase 9 dp1"),
    (("legs", "dp2", "info", "tree_overflow"), 3, "overflow"),
    (("legs", "dp4", "pos_bad"), 5, "outside rtol"),
    (("legs", "dp2", "rho_bad"), 1, "outside rtol"),
    (("legs", "dp4", "non_finite"), ["vel"], "non-finite"),
    (("legs", "dp2", "groups"), 2067, "G == NB"),
    (("legs", "dp4", "rank_launches", 2, "pass2"), 63, "rank 2"),
    (("legs", "dp1", "launches", "filter_sph"), 0, "no launch"),
    (("cases", 0, "ok"), False, "disagrees"),
    (("single", "overflow", "nbr_overflow"), 1, "single path"),
    (("cli", "rc"), 1, "cli --devices 2"),
    (("cli", "lines"), [], "cli --devices 2"),
    (("cli_indivisible", "rc"), 0, "not 2"),
], ids=lambda v: str(v)[:24])
def test_phase9_failures_name_what_failed(path, value, word):
    rep = _phase9()
    _spoil(rep, path, value)
    fails = cs.dp_failures(rep)
    assert any(word in f for f in fails), fails


def test_phase9_missing_kernel_cases_fail():
    rep = _phase9()
    rep["cases"] = [c for c in rep["cases"] if c["legs"] != ["dp4"]]
    assert any("not checked" in f for f in cs.dp_failures(rep))


def test_dp_agreement_counts_entries_outside_the_bounds():
    ref = {"pos": torch.ones(4, 3), "rho": torch.ones(4)}
    pos = ref["pos"].clone()
    pos[1, 2] += 5e-3            # past atol + rtol * 1
    rho = ref["rho"].clone()
    rho[3] *= 1.0 + 1e-3         # inside rtol
    got = cs.dp_agreement(pos, rho, ref)
    assert (got["pos_bad"], got["rho_bad"]) == (1, 0)
    assert got["pos_max_abs_err"] == pytest.approx(5e-3, rel=1e-3)
    assert got["rho_max_rel_err"] == pytest.approx(1e-3, rel=1e-3)


def test_morton_order_is_the_cubic_box_curve():
    pos = torch.tensor([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [0.9, 0.0, 0.0],
                        [0.0, 0.2, 0.0]])
    # a cubic box of side 1: x = 0.9 sorts past y = 0.2 on the curve
    assert cs.morton_order(pos).tolist() == [1, 3, 2, 0]


# ---- phases 10 and 11: the halo layout, the developer tools ----------------

PHASE10 = os.path.join(ROOT, "tests", "chip_smoke_phase10_report.json")


def _phase10():
    import json
    with open(PHASE10) as f:
        return json.load(f)


def test_phase10_recorded_report_passes():
    """Phases 10 and 11 of a report recorded on the card: the ball, the
    collision's two legs (8 gloo ranks, R = 3), every halo kernel launched
    on each leg and held against its plain version on rank 0's inputs,
    the one-device run of the same state, halo_debug's lines, the
    command line's refusal, and the ten developer tools."""
    rep = _phase10()
    halo, tools = rep["halo"], rep["tools_a8"]
    assert cs.halo_failures(halo) == []
    assert cs.tools_a8_failures(tools) == []
    s = halo["runs"]["halo_collision"]["summary"]
    assert (s["n"], s["ranks"], s["backend"]) == (cs.HALO_N, 8, "gloo")
    assert s["dpos_p99"] <= cs.HALO_POS_GATE * s["scale"]
    assert len(halo["runs"]["halo_collision"]["leg1_viol"]) == 8
    assert {c["name"] for c in halo["cases"]} == set(cs.HALO_KERNELS)
    assert set(tools["runs"]) == {t[0] for t in cs.A8_TOOLS}


@pytest.mark.parametrize("path,value,word", [
    (("runs", "settle_ball", "rc"), 3, "settle_ball"),
    (("runs", "settle_ball", "launches", "pass2"), 0, "no launch"),
    (("runs", "halo_collision", "summary"), None, "no summary"),
    (("runs", "halo_collision", "summary", "dpos_p99"), 1.0, "|dpos| p99"),
    (("runs", "halo_collision", "rc"), 5, "exit 5"),
    (("runs", "halo_collision", "summary", "leg1_overflow", "leg1_halo"),
     [3, 0], "leg 1 overflow"),
    (("runs", "halo_collision", "summary", "leg2_overflow"), [0, 7],
     "leg 2"),
    (("runs", "halo_collision", "summary", "leg2_finite"), False, "leg 2"),
    (("runs", "halo_collision", "summary", "launches", "leg2", "p2p"), 0,
     "no launch"),
    (("runs", "halo_collision", "leg1_viol"), [808], "segments"),
    (("cases", 0, "ok"), False, "disagrees"),
    (("runs", "halo_debug", "lines"), [], "halo_debug"),
    (("runs", "cli", "rc"), 0, "phase 10 cli"),
    (("runs", "cli", "lines"), ["clamped to 1"], "phase 10 cli"),
], ids=lambda v: str(v)[:24])
def test_phase10_failures_name_what_failed(path, value, word):
    rep = _phase10()["halo"]
    _spoil(rep, path, value)
    fails = cs.halo_failures(rep)
    assert any(word in f for f in fails), fails


def test_phase10_accepts_the_tools_dvel_bar_alone():
    """The collision tool exits 2 when its fixed |dvel| bar fails (the
    reference's 32k run fails it too): phase 10 accepts that exit only
    while the position gate passes."""
    rep = _phase10()["halo"]
    s = rep["runs"]["halo_collision"]["summary"]
    rep["runs"]["halo_collision"]["rc"] = 2
    s["dvel_p99"] = 2 * cs.HALO_DVEL_BAR
    assert cs.halo_failures(rep) == []
    s["dpos_p99"] = 2 * cs.HALO_POS_GATE * s["scale"]
    assert any("exit 2" in f for f in cs.halo_failures(rep))


@pytest.mark.parametrize("key,value", [
    ("rc", 1), ("missing", ["build (full)"]),
    ("failed_lines", ["xwk16bf: FAILED ..."])])
def test_phase11_failures_name_the_tool(key, value):
    rep = _phase10()["tools_a8"]
    rep["runs"]["ksweep2"][key] = value
    assert any("ksweep2" in f for f in cs.tools_a8_failures(rep))
    del rep["runs"]["micro_gather"]
    assert any("micro_gather: not run" in f
               for f in cs.tools_a8_failures(rep))
