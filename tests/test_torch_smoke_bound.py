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
    kw = dict(b=b, nv_p2p=_nv(2), p2p_rows=p2p, g_const=1.0)
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


# ---- the all-pairs kernels -------------------------------------------------

def _four_particles():
    """x = 0, 0.5 (h = 1), x = 5 (h = 3), x = 100 (h = 1). Ordered pairs
    inside either support: (0,1), (1,0) with q_i, q_j < 1; (0,2), (1,2)
    with q_i >= 2 and 1 <= q_j < 2; (2,0), (2,1) the reverse. The six pairs
    with particle 3 lie outside both supports. Dyer-Ip under
    max-softening: near only for (0,1), (1,0)."""
    pos = torch.tensor([[0.0, 0, 0], [0.5, 0, 0], [5.0, 0, 0],
                        [100.0, 0, 0]])
    h = torch.tensor([1.0, 1.0, 3.0, 1.0])
    return pos, h, torch.ones(4)


def _pw_common(n=4):
    return cs.OPS_PW_SELF * n * n + cs.OPS_PW_GEOM * n * (n - 1)


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
    grav = 12 * (cs.OPS_PW_GRAV - fmin) + 2 * di["near"] + 10 * di["far"]
    assert ops == _pw_common() + sph + grav
    assert nbytes == (48 + 16 + 16) + (16 + 16 + 16 + 48 + 16)
    assert by == "bytes"          # four particles: the arrays outweigh it
    # without gravity only the geometry and the spline branches remain
    cfg0 = cfg.replace(gravity_solver="none")
    _, _, _, ops0 = cs.pairwise_bound("pairwise_pass1", args, {}, cfg0,
                                      tuple(pw.pass1(*args, cfg0)))
    assert ops0 == _pw_common() + sph


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
