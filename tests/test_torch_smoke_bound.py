"""chip_smoke.py's bound counts only the work this data needs.

Each case places a few window slots in known branches (q < 1, 1 <= q < 2,
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
