"""chip_smoke.py's bound counts only the work this data needs.

Each case places a few window slots (for the all-pairs kernels: four
particles) in known branches (q < 1, 1 <= q < 2,
q >= 2; Dyer-Ip x < 1 and x >= 1; a slot with m = 0 and one past nv) and
checks the operation and byte counts against the per-branch costs written
beside the constants in ``chip_smoke.py``. Runs on the CPU through the
kernels' plain versions.
"""

import importlib.util
import os

import pytest
import torch

from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()


def _col(vals):
    return torch.tensor(vals, dtype=torch.float32).reshape(-1, 1)


def _row(vals):
    return torch.tensor([vals], dtype=torch.float32)


def _nv(n):
    return torch.tensor([n], dtype=torch.int32)


def test_pass1_ops_and_bytes_by_branch():
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    # q = 0.5 (inner), 1.5 (outer), 3 (none), an m = 0 slot, one past nv
    src = [_row([0.5, 1.5, 3.0, 0.2, 0.1]), _row([0.0] * 5),
           _row([0.0] * 5), _row([1.0, 1.0, 1.0, 0.0, 1.0])]
    a = (_nv(4), [zero, zero, zero, one], src)
    out = gk2.pass1_gradh(*a, b=b)
    _, _, nbytes, ops = cs.bound("pass1_gradh", a, {"b": b}, out)
    p = cs.OPS_P1
    assert ops == b * (p["inner"] + p["outer"] + p["none"]) \
        + 4 * cs.OPS_SLOT_TEST
    assert nbytes == 4 * b * 4 + 4 + 4 * 4 * 4 + 3 * b * 4


def test_pass2_ops_by_branch():
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    # SPH: r = 0.5 (gw inner both sides, Dyer-Ip near), r = 3 (gw 0, far)
    src = [_row([0.5, 3.0, 0.0]), _row([0.0] * 3), _row([0.0] * 3),
           _row([1.0] * 3), _row([1.0, 1.0, 1.0]), _row([1.0] * 3)]
    # P2P: r = 0.5 (near), r = 5 (far), a third slot past nv
    p2p = [_row([0.5, 5.0, 0.0]), _row([0.0] * 3), _row([0.0] * 3),
           _row([1.0] * 3), _row([1.0] * 3)]
    a = (_nv(2), [zero, zero, zero, one, one], src)
    kw = dict(b=b, mode="grad_h", grav=True, nv_p2p=_nv(2), p2p_rows=p2p,
              g_const=1.0)
    out = gk2.pass2(*a, **kw)
    _, _, _, ops = cs.bound("pass2", a, kw, out)
    base = cs.OPS_GEOM + cs.OPS_COUNT
    di, gw = cs.OPS_DYER_IP, cs.OPS_GW
    near_pair = (base + cs.OPS_GW_PAIR + di["near"] + 2 * gw["inner"]
                 + cs.OPS_GW_JH4 + cs.OPS_GP_SUM)
    far_pair = base + cs.OPS_GW_PAIR + di["far"] + 2 * gw["none"]
    p2p_pairs = 2 * base + di["near"] + di["far"]
    assert ops == b * (near_pair + far_pair + p2p_pairs) \
        + 4 * cs.OPS_SLOT_TEST


@pytest.mark.parametrize("nm", [4, 10])
def test_gravity_ops_count_far_tests_per_group(nm):
    b = 2
    tgt = [_col([0.0] * b)] * 3 + [_col([1.0] * b)]

    def moments(m, x):
        return ([_row(m), _row(x), _row([0.0] * len(m)),
                 _row([0.0] * len(m))]
                + [_row([0.1] * len(m))] * 6)[:nm]

    ring = moments([1.0, 0.0, 1.0], [5.0, 6.0, 7.0])       # nv 2: 1 live
    far = moments([1.0, 1.0, 0.0, 1.0], [10.0, 11.0, 12.0, 13.0])
    accept = _row([1.0, 0.0, 1.0, 1.0])                    # 2 live
    a = (_nv(2), tgt, ring, far, accept)
    out = gk2.gravity_fused(*a, b=b)
    _, _, _, ops = cs.bound("gravity_fused", a, {"b": b}, out)
    per = cs.OPS_MONO + (cs.OPS_QUAD if nm == 10 else 0)
    assert ops == b * per * 3 + 2 + 4 + 3


def test_filter_ops_stop_at_first_hit_and_bytes_skip_past_nv():
    b = 3
    tgt = [_col([0.0, 10.0, 20.0]), _col([0.0] * b), _col([0.0] * b),
           _col([1.0] * b), _col([0.0] * b)]
    # first hits at target 3 and target 1, a slot hitting none, an m = 0
    # slot, then two slots past nv
    x = [20.5, 0.5, 50.0, 0.0, 0.0, 0.0]
    src = [_row(x), _row([0.0] * 6), _row([0.0] * 6), _row([1.0] * 6),
           _row([0.0] * 6), _row([1.0, 1.0, 1.0, 0.0, 1.0, 1.0])]
    a = (_nv(4), tgt, src)
    out = gk2.filter_sph(*a, b=b)
    _, _, nbytes, ops = cs.bound("filter_sph", a, {"b": b}, out)
    assert ops == cs.OPS_FILTER * (3 + 1 + 3) + 4 * cs.OPS_SLOT_TEST
    assert nbytes == 5 * b * 4 + 4 + 4 * 6 * 4 + 6 * 4


def test_filter_shares_beside_the_bound_by_hand():
    """The same window as the filter's bound test: targets at x = 0, 10,
    20 (one box, cut 1), live slots at x = 20.5, 0.5 and 50. The bound
    charges 3 + 1 + 3 tests; the kernel tests the box's targets for each of
    the slots it keeps, to the first hit (3 and 1 tests), and pre-rejects
    the slot at 50 whole (its gap to the box, 30, is far beyond the
    cut)."""
    b = 3
    tgt = [_col([0.0, 10.0, 20.0]), _col([0.0] * b), _col([0.0] * b),
           _col([1.0] * b), _col([0.0] * b)]
    x = [20.5, 0.5, 50.0, 0.0, 0.0, 0.0]
    src = [_row(x), _row([0.0] * 6), _row([0.0] * 6), _row([1.0] * 6),
           _row([0.0] * 6), _row([1.0, 1.0, 1.0, 0.0, 1.0, 1.0])]
    sh = cs.window_shares("filter_sph", (_nv(4), tgt, src), {"b": b})
    assert (sh["live_slots"], sh["kept"], sh["prerejected"]) == (3, 2, 1)
    assert (sh["tests"], sh["boxes_tested"]) == (4, 2 / 3)
    assert sh["charged_per_live"] == pytest.approx(7 / 3)
    _, _, _, ops = cs.bound("filter_sph", (_nv(4), tgt, src), {"b": b},
                            gk2.filter_sph(_nv(4), tgt, src, b=b))
    assert ops == cs.OPS_FILTER * sh["charged_per_live"] * 3 \
        + 4 * cs.OPS_SLOT_TEST


# ---- the all-pairs kernels -------------------------------------------------

def _four_particles():
    """x = 0, 0.5 (h = 1), x = 5 (h = 3), x = 100 (h = 1). Ordered pairs
    inside either support: (0,1), (1,0) with q_i, q_j < 1; (0,2), (1,2)
    with q_i >= 2 and 1 <= q_j < 2; (2,0), (2,1) the reverse; the q^2 test
    keeps these six. The six pairs with particle 3 lie outside both
    supports and the test skips them. Dyer-Ip under either softening: near
    only for (0,1), (1,0)."""
    pos = torch.tensor([[0.0, 0, 0], [0.5, 0, 0], [5.0, 0, 0],
                        [100.0, 0, 0]])
    h = torch.tensor([1.0, 1.0, 3.0, 1.0])
    return pos, h, torch.ones(4)


def _pw_common(n=4, kept=6):
    return cs.OPS_PW_SKIP * n * (n - 1) + cs.OPS_PW_NEAR * kept


@pytest.mark.parametrize("softening", ["symmetric_max", "receiver_h"])
def test_pairwise_pass1_ops_and_bytes_by_branch(softening):
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    cfg = tc.jupiter_3k(n=4, softening_mode=softening)
    args = _four_particles()
    out = pw.pass1(*args, cfg)
    assert out.n_neighbors.tolist() == [1, 1, 2, 0]
    _, by, nbytes, ops = cs.pairwise_bound("pairwise_pass1", args, {}, cfg,
                                           tuple(out))
    w, di = cs.OPS_PW_W, cs.OPS_DYER_IP
    sph = 6 * cs.OPS_PW_RHO + 4 * (w["inner"] + w["outer"] + w["none"])
    fmin = 1 if softening == "receiver_h" else 0
    # the six skipped pairs take the outer branch alone; of the six kept,
    # two are near and four far
    grav = (6 * cs.OPS_PW_GRAV_FAR + 6 * (cs.OPS_PW_GRAV - fmin)
            + 2 * di["near"] + 4 * di["far"])
    assert ops == _pw_common() + sph + grav
    assert nbytes == (48 + 16 + 16) + (16 + 16 + 16 + 48 + 16)
    assert by == "bytes"          # four particles: the arrays outweigh it
    # without gravity only the geometry and the spline branches remain
    cfg0 = cfg.replace(gravity_solver="none")
    _, _, _, ops0 = cs.pairwise_bound("pairwise_pass1", args, {}, cfg0,
                                      tuple(pw.pass1(*args, cfg0)))
    assert ops0 == _pw_common() + sph


def test_pairwise_shares_by_hand():
    """Of the twelve ordered pairs, six lie inside either support and the
    q^2 test skips the other six; a particle moved to the knife edge of
    the larger support (r ih_min = 2 exactly) is inside no support and
    still kept by the test."""
    pos, h, _ = _four_particles()
    sh = cs.pairwise_shares(pos, h)
    assert sh == dict(pairs=12, inside_share=0.5, skipped_share=0.5)
    pos[3, 0] = 11.0                  # r = 6 from x = 5 (h = 3): q = 2
    sh = cs.pairwise_shares(pos, h)
    assert sh["inside_share"] == 0.5 and sh["skipped_share"] == 4 / 12


def _pass2_args():
    pos, h, m = _four_particles()
    return (pos, h, m, torch.ones(4), torch.ones(4))


def _pw_grad():
    g = cs.OPS_PW_GW
    return (4 * (g["inner"] + g["outer"] + g["none"])
            + 4 * cs.OPS_PW_GW_CJ + 6 * cs.OPS_PW_GW_SYM)


@pytest.mark.parametrize("mode", ["symmetric", "reference_asymmetric"])
def test_pairwise_pass2_ops_by_branch(mode):
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    cfg = tc.jupiter_3k(n=4, grad_p_mode=mode)
    args = _pass2_args()
    out = pw.pass2(*args, cfg)
    _, _, nbytes, ops = cs.pairwise_bound("pairwise_pass2", args, {}, cfg,
                                          (out,))
    coef = cs.OPS_PW_COEF["symmetric" if mode == "symmetric"
                          else "asymmetric"]
    assert ops == _pw_common() + _pw_grad() + 6 * (coef + cs.OPS_PW_GP_SUM)
    assert nbytes == (48 + 4 * 16) + 48


@pytest.mark.parametrize("sign,approaching", [(-1.0, 6), (1.0, 0)])
def test_pairwise_pass2_viscosity_ops_count_approaching_pairs(sign,
                                                              approaching):
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    cfg = tc.jupiter_3k(n=4, av_alpha=1.0, av_beta=2.0, av_balsara=True,
                        kernel_deriv_sign_bug=True)
    args = _pass2_args()
    # homologous contraction (every pair approaches) or expansion (none)
    kw = dict(vel=sign * 0.1 * args[0], fbal=torch.ones(4))
    out = pw.pass2(*args, cfg, **kw)
    _, _, nbytes, ops = cs.pairwise_bound("pairwise_pass2", args, kw, cfg,
                                          tuple(out))
    base = _pw_common() + _pw_grad() + 6 * (cs.OPS_PW_COEF["symmetric"]
                                            + cs.OPS_PW_GP_SUM)
    av = (6 * cs.OPS_PW_VDOTR
          + approaching * (cs.OPS_PW_PI + cs.OPS_PW_PI_BAL)
          + _pw_grad()            # the correct derivative again (sign bug)
          + 6 * cs.OPS_PW_DC)
    assert ops == base + av
    assert nbytes == (48 + 4 * 16) + (48 + 16) + (48 + 64)


# ---- the other modes of the windowed kernels -------------------------------

@pytest.mark.parametrize("skipped", [0, 1, 2], ids=["in_support",
                                                   "one_skipped",
                                                   "two_skipped"])
def test_pass1_sym_ops_and_bytes_by_branch(skipped):
    """In-support pairs: the geometry, the count, both splines by branch
    and the sums; pairs outside both supports (r min(ih_i, ih_j) >= 2):
    only the geometry and the skip test."""
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    # r = 0.5: q_i inner, q_j (h_j = 0.25) at 2 -> none; r = 1.5: q_i outer,
    # q_j (h_j = 2) inner; `skipped` slots outside both supports (r = 3 and
    # 5, h_j = 1); an m = 0 slot; one past nv
    far = [3.0, 5.0][:skipped]
    n = 2 + skipped
    src = [_row([0.5, 1.5, *far, 0.2, 0.1]), _row([0.0] * (n + 2)),
           _row([0.0] * (n + 2)), _row([4.0, 0.5] + [1.0] * skipped
                                       + [1.0, 1.0]),
           _row([1.0] * n + [0.0, 1.0])]
    a = (_nv(n + 1), [zero, zero, zero, one], src)
    out = gk2.pass1_sym(*a, b=b)
    _, _, nbytes, ops = cs.bound("pass1_sym", a, {"b": b}, out)
    w = cs.OPS_P1S_W
    per_pair = cs.OPS_P1S_GEOM + cs.OPS_P1S_SUM_I + cs.OPS_P1S_SUM_J
    assert cs.OPS_P1S_SKIP < per_pair + 2 * w["none"]   # the bound falls
    assert ops == b * (2 * per_pair + 2 * w["inner"] + w["outer"]
                       + w["none"] + skipped * cs.OPS_P1S_SKIP) \
        + (n + 1) * cs.OPS_SLOT_TEST
    assert nbytes == 4 * b * 4 + 4 + (n + 1) * 5 * 4 + 2 * b * 4


@pytest.mark.parametrize("receiver", [False, True])
def test_p2p_ops_by_branch(receiver):
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    # r = 0.5 (near), r = 5 (far), an m = 0 slot, one past nv
    rows = [_row([0.5, 5.0, 0.1, 0.0]), _row([0.0] * 4), _row([0.0] * 4),
            _row([1.0] * 4), _row([1.0, 1.0, 0.0, 1.0])]
    if receiver:
        del rows[3]
    a = (_nv(3), [zero, zero, zero, one], rows)
    kw = dict(b=b, receiver_soft=receiver, g_const=1.0)
    out = gk2.p2p(*a, **kw)
    _, _, nbytes, ops = cs.bound("p2p", a, kw, out)
    di = cs.OPS_DYER_IP
    pair = cs.OPS_GEOM + cs.OPS_COUNT - (1 if receiver else 0)
    assert ops == b * (2 * pair + di["near"] + di["far"]) \
        + 3 * cs.OPS_SLOT_TEST
    assert nbytes == 4 * b * 4 + 4 + 3 * len(rows) * 4 + 5 * b * 4


@pytest.mark.parametrize("mode", ["symmetric", "reference_asymmetric"])
def test_pass2_modes_ops_without_gravity(mode):
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    src = [_row([0.5, 3.0, 0.0]), _row([0.0] * 3), _row([0.0] * 3),
           _row([1.0] * 3), _row([1.0, 1.0, 1.0]), _row([1.0] * 3)]
    tgt = [zero, zero, zero, one] + ([one] if mode == "symmetric" else [])
    a = (_nv(2), tgt, src)
    kw = dict(b=b, mode=mode)
    out = gk2.pass2(*a, **kw)
    assert len(out) == 3
    _, _, nbytes, ops = cs.bound("pass2", a, kw, out)
    gw = cs.OPS_GW
    near_pair = (cs.OPS_GEOM + cs.OPS_GW_PAIR + 2 * gw["inner"]
                 + cs.OPS_GW_JH4 + cs.OPS_GP_SUM + cs.OPS_GP_MODE[mode])
    far_pair = cs.OPS_GEOM + cs.OPS_GW_PAIR + 2 * gw["none"]
    assert ops == b * (near_pair + far_pair) + 2 * cs.OPS_SLOT_TEST
    assert nbytes == len(tgt) * b * 4 + 4 + 2 * 6 * 4 + 3 * b * 4


@pytest.mark.parametrize("sign,approaching", [(-1.0, 1), (1.0, 0)])
def test_pass2_viscosity_ops_count_approaching_pairs(sign, approaching):
    # the source at x = 0.5 moves along x with velocity 0.1 * sign: towards
    # the target at the origin for sign = -1
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    n = 3
    # the pair at r = 3 lies outside both supports: no viscosity work
    src = [_row([0.5, 3.0, 0.0]), _row([0.0] * n), _row([0.0] * n),
           _row([1.0] * n), _row([1.0] * n), _row([1.0] * n),
           _row([sign * 0.1, sign * 0.1, 0.0]), _row([0.0] * n),
           _row([0.0] * n), _row([1.0] * n), _row([1.0] * n),
           _row([1.0] * n), _row([1.0] * n)]
    tgt = [zero, zero, zero, one, one, zero, zero, zero, one, one, one, one]
    a = (_nv(2), tgt, src)
    kw = dict(b=b, mode="grad_h", av=True, balsara=True, sign_bug=True,
              av_alpha=1.0, av_beta=2.0, grav=True, receiver_soft=True)
    out = gk2.pass2(*a, **kw)
    assert len(out) == 15
    _, _, _, ops = cs.bound("pass2", a, kw, out)
    gw, di = cs.OPS_GW, cs.OPS_DYER_IP
    gw_near = 2 * gw["inner"] + cs.OPS_GW_JH4
    gw_far = 2 * gw["none"]
    base = cs.OPS_GEOM + cs.OPS_GW_PAIR + cs.OPS_COUNT - 1    # receiver
    near_pair = (base + 2 * gw_near + cs.OPS_GP_SUM + di["near"]
                 + cs.OPS_AV_VDOTR + cs.OPS_AV_GSYM + cs.OPS_AV_DC
                 + approaching * (cs.OPS_AV_PI + cs.OPS_AV_SUM
                                  + cs.OPS_AV_BAL))
    far_pair = base + 2 * gw_far + di["far"]
    assert ops == b * (near_pair + far_pair) + 2 * cs.OPS_SLOT_TEST


def test_gravity_ops_with_the_near_tier():
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    tgt = [zero, zero, zero, one]
    ring = [_row([1.0, 1.0]), _row([5.0, 6.0]), _row([0.0] * 2),
            _row([0.0] * 2)]
    far = [_row([1.0, 1.0]), _row([10.0, 11.0]), _row([0.0] * 2),
           _row([0.0] * 2)]
    accept = _row([1.0, 0.0])
    p2p = [_row([0.5, 5.0, 0.0]), _row([0.0] * 3), _row([0.0] * 3),
           _row([1.0] * 3), _row([1.0] * 3)]
    a = (_nv(1), tgt, ring, far, accept)
    kw = dict(b=b, nv_p2p=_nv(2), p2p_rows=p2p, receiver_soft=False)
    out = gk2.gravity_fused(*a, **kw)
    assert out[4].tolist() == [[2]] * b and out[5].tolist() == [[2]] * b
    _, _, nbytes, ops = cs.bound("gravity_fused", a, kw, out)
    di = cs.OPS_DYER_IP
    near = 2 * (cs.OPS_GEOM + cs.OPS_COUNT) + di["near"] + di["far"]
    assert ops == b * (cs.OPS_MONO * 2 + near) + 1 + 2 + 1 \
        + 2 * cs.OPS_SLOT_TEST
    # the softening column is read now; both windows below their nv
    assert nbytes == (4 * b * 4 + (4 + 1 * 4 * 4) + (4 + 2 * 5 * 4)
                      + 4 * 2 * 4 + 2 * 4 + 6 * b * 4)


def test_expected_launches_of_the_grid_legs():
    from planetmodel_sph_tpu_torch import config as tc
    base = tc.jupiter_100k()
    assert cs.expected_launches(base, 64) == {
        "filter_sph": 4, "pass1_gradh": 68, "pass2": 64, "gravity_fused": 4}
    sym = base.replace(**cs.SYM_KW)
    assert cs.expected_launches(sym, 64) == {
        "filter_sph": 2, "pass1_sym": 64, "pass2": 64, "p2p": 64,
        "gravity_fused": 4}
    assert cs.expected_launches(
        sym.replace(respa_every=1, rebuild_every=8), 8) == {
        "filter_sph": 1, "pass1_sym": 8, "pass2": 8, "gravity_fused": 8}
    settle = tc.jupiter_100k(**cs.SETTLE_KW)
    assert cs.expected_launches(settle, 16) == {
        "filter_sph": 4, "pass1_gradh": 20, "pass2": 16,
        "gravity_fused": 16}


def test_slice_args_cuts_groups_and_keeps_shared_rows():
    g, b = 4, 2
    nv = torch.arange(g, dtype=torch.int32)
    col = torch.arange(g * b, dtype=torch.float32).reshape(-1, 1)
    row = torch.arange(g * 3, dtype=torch.float32).reshape(g, 3)
    far = torch.zeros(1, 8)
    a, kw = cs.slice_args((nv, [col], [row], [far], row),
                          dict(b=b, g_const=2.0, nv_p2p=nv, p2p_rows=[row],
                               receiver_soft=False), 1, 3)
    assert a[0].tolist() == [1, 2] and a[1][0].shape == (2 * b, 1)
    assert a[2][0].shape == (2, 3) and a[3][0].shape == (1, 8)
    assert kw["nv_p2p"].tolist() == [1, 2] and "b" not in kw
    assert kw["g_const"] == 2.0 and kw["p2p_rows"][0].shape == (2, 3)


@pytest.mark.parametrize("mode", ["grad_h", "symmetric"])
@pytest.mark.parametrize("av", [False, True])
def test_pass2_energy_ops_and_bytes(mode, av):
    """The energy column's charge: the pressure work on the pair inside the
    support, v.d unless the viscosity has it, half the dissipation on the
    approaching pair; one more output column, and without viscosity three
    velocity rows and columns."""
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    n = 3
    # r = 0.5: inside both supports, approaching; r = 3: outside
    src = [_row([0.5, 3.0, 0.0]), _row([0.0] * n), _row([0.0] * n),
           _row([1.0] * n), _row([1.0] * n), _row([1.0] * n),
           _row([-0.1, -0.1, 0.0]), _row([0.0] * n), _row([0.0] * n)]
    tgt = [zero, zero, zero, one, one, zero, zero, zero]
    if av:
        src += [_row([1.0] * n)] * 3
        tgt += [one, one, one]
    a = (_nv(2), tgt, src)
    kw = dict(b=b, mode=mode, av=av, energy=True, av_alpha=1.0, av_beta=2.0)
    out = gk2.pass2(*a, **kw)
    assert len(out) == (7 if av else 4)
    _, _, nbytes, ops = cs.bound("pass2", a, kw, out)
    plain = dict(kw, energy=False)
    a0 = a if av else (a[0], tgt[:5], src[:6])
    out0 = gk2.pass2(*a0, **plain)
    _, _, nbytes0, ops0 = cs.bound("pass2", a0, plain, out0)
    extra = cs.OPS_EN[mode] + (cs.OPS_EN_AV if av else cs.OPS_EN_VDOTR)
    assert ops - ops0 == b * extra
    # du column; without viscosity also 3 target columns and 3 rows in the
    # two slots below nv
    assert nbytes - nbytes0 == b * 4 + (0 if av else 3 * b * 4 + 2 * 3 * 4)
    assert float(out[-1].abs().max()) > 0.0


def test_pass2_tolerances_follow_the_energy_flag():
    assert len(cs.pass2_tol(dict(av=True, balsara=True, energy=True,
                                 grav=True))) == 16
    assert len(cs.pass2_tol(dict(energy=True))) == 4
    assert cs.pass2_tol(dict(energy=True))[3] == (1e-4, 1e-4)


@pytest.mark.parametrize("near", [False, True])
def test_gravity_ops_with_the_blk_tier(near):
    """The blk tier's entries are charged as the ring's: one multipole
    evaluation per target and live entry, the m test per slot below
    nv_blk, its rows' bytes below nv_blk."""
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    tgt = [zero, zero, zero, one]
    ring = [_row([1.0, 1.0]), _row([5.0, 6.0]), _row([0.0] * 2),
            _row([0.0] * 2)]
    far = [_row([1.0, 1.0]), _row([10.0, 11.0]), _row([0.0] * 2),
           _row([0.0] * 2)]
    accept = _row([1.0, 0.0])
    # three slots below nv_blk, one of them with m = 0; a fourth past it
    blk = [_row([1.0, 0.0, 2.0, 1.0]), _row([20.0, 21.0, 22.0, 23.0]),
           _row([0.0] * 4), _row([0.0] * 4)]
    p2p = [_row([0.5, 5.0, 0.0]), _row([0.0] * 3), _row([0.0] * 3),
           _row([1.0] * 3), _row([1.0] * 3)]
    a = (_nv(1), tgt, ring, far, accept)
    nkw = dict(nv_p2p=_nv(2), p2p_rows=p2p, receiver_soft=False) if near \
        else {}
    kw = dict(b=b, nv_blk=_nv(3), blk_rows=blk, **nkw)
    out = gk2.gravity_fused(*a, **kw)
    bare = gk2.gravity_fused(*a, b=b, **nkw)
    assert (out[5] - bare[5]).tolist() == [[2]] * b
    _, _, nbytes, ops = cs.bound("gravity_fused", a, kw, out)
    _, _, nbytes0, ops0 = cs.bound("gravity_fused", a, dict(b=b, **nkw),
                                   bare)
    assert ops - ops0 == b * cs.OPS_MONO * 2 + 3
    assert nbytes - nbytes0 == 4 + 3 * 4 * 4


def test_expected_launches_of_the_energy_and_supergroup_legs():
    from planetmodel_sph_tpu_torch import config as tc
    base = tc.jupiter_100k()
    adia = base.replace(**cs.ADIA_KW)
    assert adia.evolves_u and adia.av_alpha == 1.0
    assert cs.expected_launches(adia, cs.ADIA_STEPS) == {
        "filter_sph": 4, "pass1_gradh": 68, "pass2": 64, "gravity_fused": 4}
    noav = adia.replace(av_alpha=0.0, rebuild_every=cs.ADIA_NOAV_STEPS,
                        respa_every=cs.ADIA_NOAV_STEPS)
    assert cs.expected_launches(noav, cs.ADIA_NOAV_STEPS) == {
        "filter_sph": 2, "pass1_gradh": 10, "pass2": 8, "gravity_fused": 2}
    sg = base.replace(**cs.SYM_KW, **cs.SG_KW)
    tc.check_slice(sg)
    assert cs.expected_launches(sg, 64) == {
        "filter_sph": 2, "pass1_sym": 64, "pass2": 64, "p2p": 64,
        "gravity_fused": 4}
    bcfg = tc.basalt_impact(**cs.BASALT100K_KW)
    tc.check_slice(bcfg)
    assert (bcfg.n, bcfg.eos_mode, bcfg.multipole_order,
            bcfg.rebuild_every) == (100_000, "tillotson", 1, 1)
    tc.check_slice(tc.basalt_impact())


def test_slice_args_cuts_the_blk_window_too():
    g, b = 4, 2
    nv = torch.arange(g, dtype=torch.int32)
    col = torch.arange(g * b, dtype=torch.float32).reshape(-1, 1)
    row = torch.arange(g * 3, dtype=torch.float32).reshape(g, 3)
    far = torch.zeros(1, 8)
    a, kw = cs.slice_args((nv, [col], [row], [far], row),
                          dict(b=b, nv_blk=nv, blk_rows=[row, row]), 2, 4)
    assert kw["nv_blk"].tolist() == [2, 3]
    assert [r.shape for r in kw["blk_rows"]] == [(2, 3)] * 2
    assert a[3][0].shape == (1, 8)


def test_probe_fma_and_launch_bound_counts():
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    x = torch.full((8, 128), 0.9)
    for reps, bound_by in ((3, "bytes"), (512, "operations")):
        out = probes.probe_fma(x, reps)
        _, by, nbytes, ops = cs.bound("probe_fma", (x,), {"reps": reps},
                                      out)
        assert nbytes == 2 * 1024 * 4 and by == bound_by
        assert ops == cs.OPS_FMA_REP * reps * 1024
    assert cs.OPS_FMA_REP == 8
    out = probes.probe_launch(x)
    _, _, nbytes, ops = cs.bound("probe_launch", (x,), {}, out)
    assert nbytes == 2 * 1024 * 4 and ops == 1024


def test_probe_gather_bound_is_the_bytes_moved():
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    packed = torch.ones((5, 12))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    out = probes.probe_gather(packed, idx)
    b_ms, by, nbytes, ops = cs.bound("probe_gather", (packed, idx), {}, out)
    assert nbytes == (5 * 12 + 6 + 2 * 3 * 12) * 4 and ops == 0
    assert by == "bytes" and b_ms == nbytes / cs.PEAK_BYTES * 1e3


def test_probe_pass1_tile_ops_and_bytes_by_branch():
    """Two targets at the origin, ih = 1 and ih = -1 (a negative q takes
    the inner branch); slots at r = 0.5 (inner), 1.5 (outer), 3 (none), a
    dead one, r = 0.2 (inner), then one past nv. chunk 4 over 8 slots:
    the extent is min(nv, trips * chunk) = 5, the span trips * chunk = 8
    (x, y and z are read over the span: a far-out position there reaches
    the sum)."""
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    tgt = [_col([0.0, 0.0])] * 3 + [_col([1.0, -1.0])]
    xs = [0.5, 1.5, 3.0, 0.4, 0.2, 0.1, 0.0, 0.0]
    live = [1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0]
    rows = [_row(xs), _row([0.0] * 8), _row([0.0] * 8), _row([1.0] * 8),
            _row(live)]
    a = (_nv(5), tgt, rows)
    kw = {"tb": 2, "chunk": 4}
    out = probes.probe_pass1_tile(*a, **kw)
    _, _, nbytes, ops = cs.bound("probe_pass1_tile", a, kw, out)
    w = cs.OPS_TILE_W
    assert ops == ((cs.OPS_TILE_GEOM + cs.OPS_TILE_SUM) * 8
                   + 6 * w["inner"] + w["outer"] + w["none"]
                   + cs.OPS_TILE_SLOT * 5 + cs.OPS_TILE_TARGET * 2)
    assert nbytes == 4 * 2 * 4 + 4 + 2 * 4 + 8 * 3 * 4 + 5 * 2 * 4
    # the second target: every q negative, the inner polynomial, and the
    # prefactor ih^3 / pi negative
    poly = sum(1.0 - 1.5 * q * q + 0.75 * q * q * q
               for q in (-0.5, -1.5, -3.0, -0.2))
    assert float(out[1, 0]) == pytest.approx(-poly / 3.141592653589793,
                                             rel=1e-5)


def test_parent_splits_are_read_from_the_checkouts_own_source():
    """--parent times the other checkout's all-pairs kernels through its
    own wrappers, with its own source splits: loaded from its source,
    this checkout's gives the wrapper's own numbers, and its wrappers run
    their plain versions here as this checkout's do."""
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    mod = cs.parent_pairwise(ROOT)
    assert mod is not pw
    for n in (1, 301, 3000, 32768, 10 ** 6):
        assert mod.splits_for(n) == pw.splits_for(n)
    cfg = tc.jupiter_3k(n=4)
    args = _four_particles()
    assert all(torch.equal(a, b) for a, b in zip(mod.pass1(*args, cfg),
                                                 pw.pass1(*args, cfg)))


def test_pairwise_instances_follow_the_flags():
    from planetmodel_sph_tpu_torch import config as tc
    cfg = tc.jupiter_3k(n=4)
    assert cs.pairwise_instance("pairwise_pass1", cfg, {}) == (
        "pairwise_pass1", (1, 0, 0))
    assert cs.pairwise_instance(
        "pairwise_pass1", cfg.replace(softening_mode="receiver_h"), {}) == (
        "pairwise_pass1", (1, 1, 0))
    assert cs.pairwise_instance(
        "pairwise_pass1", cfg.replace(gravity_solver="none"), {}) == (
        "pairwise_pass1", (0, 0, 0))
    assert cs.pairwise_instance("pairwise_pass1", cfg, {}, True) == (
        "pairwise_pass1", (1, 0, 1))
    av = cfg.replace(av_alpha=1.0, av_balsara=True)
    assert cs.pairwise_instance("pairwise_pass2", av, {}) == (
        "pairwise_pass2", (0, 0, 0))
    assert cs.pairwise_instance("pairwise_pass2", av, {"vel": 1}) == (
        "pairwise_pass2", (1, 1, 0))
    assert cs.pairwise_instance("pairwise_pass2", av, {"vel": 1}, True) == (
        "pairwise_pass2", (1, 1, 1))


@pytest.mark.parametrize("receiver", [False, True])
def test_p2p_bf16_ops_by_branch(receiver):
    """A bf16 p2p call: each live pair's polynomial moves to bf16 (by its
    branch) with the pair's casts, the rest stays f32; the bound charges
    the bf16 operations at the packed peak."""
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    rows = [_row([0.5, 5.0, 0.1, 0.0]), _row([0.0] * 4), _row([0.0] * 4),
            _row([1.0] * 4), _row([1.0, 1.0, 0.0, 1.0])]
    if receiver:
        del rows[3]
    a = (_nv(3), [zero, zero, zero, one], rows)
    kw = dict(b=b, receiver_soft=receiver, g_const=1.0)
    f32 = cs.bound("p2p", a, kw, gk2.p2p(*a, **kw))
    kw16 = dict(kw, bf16=True)
    b_ms, by, nbytes, ops = cs.bound("p2p", a, kw16, gk2.p2p(*a, **kw16))
    moved, bf = cs._bf16_ops("p2p", a, kw16)
    inb = cs.OPS_DYER_IP_IN_BF16
    assert moved == b * (inb["near"] + inb["far"])
    assert bf == moved + 2 * b * cs.OPS_CAST_PAIR
    assert ops == f32[3] - moved + bf and nbytes == f32[2]
    t_ops = ((f32[3] - moved) / cs.PEAK_F32 + bf / cs.PEAK_BF16) * 1e3
    assert b_ms == pytest.approx(max(t_ops, nbytes / cs.PEAK_BYTES * 1e3))


def test_gravity_bf16_ops_move_the_monopoles_and_the_near_tier():
    """A bf16 gravity_fused call: each live entry's monopole magnitude and
    each near pair's polynomial move to bf16, with their casts; the
    quadrupole stays f32."""
    b = 2
    zero, one = _col([0.0] * b), _col([1.0] * b)
    tgt = [zero, zero, zero, one]
    q = [_row([0.1, 0.1])] * 6
    ring = [_row([1.0, 1.0]), _row([5.0, 6.0]), _row([0.0] * 2),
            _row([0.0] * 2)] + q
    far = [_row([1.0, 1.0]), _row([10.0, 11.0]), _row([0.0] * 2),
           _row([0.0] * 2)] + q
    p2p = [_row([0.5, 5.0, 0.0]), _row([0.0] * 3), _row([0.0] * 3),
           _row([1.0] * 3), _row([1.0] * 3)]
    a = (_nv(1), tgt, ring, far, _row([1.0, 0.0]))
    kw = dict(b=b, nv_p2p=_nv(2), p2p_rows=p2p, receiver_soft=False,
              bf16=True)
    moved, bf = cs._bf16_ops("gravity_fused", a, kw)
    inb = cs.OPS_DYER_IP_IN_BF16
    # two live entries (a ring slot, an accepted far entry), two pairs
    assert moved == b * (2 * cs.OPS_MONO_IN_BF16 + inb["near"] + inb["far"])
    assert bf == moved + b * (2 * cs.OPS_CAST_MONO + 2 * cs.OPS_CAST_PAIR)
    _, _, _, ops = cs.bound("gravity_fused", a, kw,
                            gk2.gravity_fused(*a, **kw))
    f32kw = dict(kw, bf16=False)
    f32 = cs.bound("gravity_fused", a, f32kw,
                   gk2.gravity_fused(*a, **f32kw))
    assert ops == f32[3] - moved + bf


def test_bf16_twins_follow_their_f32_cases():
    """Each f32 case of BF16_TWINS is followed by its twin on the same
    inputs with bf16=True; the legs of the twins are the bf16 legs."""
    kw = {"b": 2}
    cases = [("p2p", "min_h", ("sym100k",), ("a",), kw),
             ("pass2", "symmetric", ("sym100k",), ("b",), kw)]
    out = list(cs.with_bf16_twins(cases))
    assert [c[:3] for c in out] == [
        ("p2p", "min_h", ("sym100k",)),
        ("p2p", "min_h+bf16", ("sym100k_bf16",)),
        ("pass2", "symmetric", ("sym100k",))]
    assert out[1][3] is out[0][3] and out[1][4] == {"b": 2, "bf16": True}
    assert "bf16" not in kw
    legs = {leg for v in cs.BF16_TWINS.values() for leg in v}
    assert legs == {"prod100k_bf16", "sym100k_bf16",
                    "sym100k_bf16_every_tier"}
    assert {n for n, _ in cs.BF16_TWINS} == {"p2p", "gravity_fused"}


def test_parent_signatures_are_read_from_the_checkouts_own_source():
    from planetmodel_sph_tpu_torch.ops.cuda import build
    assert cs.parent_signatures(ROOT) == build.SIGNATURES
