"""Every mode of the port's windowed kernels (plain PyTorch versions)
against the JAX package's sweeps, on the same numpy inputs.

Covers what tests/test_torch_groups2.py does not: ``pass1_sym``, ``p2p`` in
both softenings, ``pass2`` in its three pressure forms with the sign bug,
viscosity, the Balsara sums, fused gravity with and without the merged
residual-P2P window and receiver softening, with the energy column (with
and without viscosity: the three-velocity layout), and ``gravity_fused``
with the near tier and with the supergroup block tier. The JAX side runs
``ops/pallas/fallback.py``; one tiny case per kernel and mode family also
runs the Pallas bodies in interpret mode
(PSPH_FORCE_INTERPRET=1). Inputs are those of test_torch_groups2.py (ragged
nv, m = 0 slots, self pairs, both sides of q = 1, q = 2 and x = 1).
Tolerances: counts exact; rho rtol 2e-6; phi rtol 3e-5; gradient, viscosity
and div/curl sums rtol 1e-5 with an atol of 1e-6 of the field's scale
(their terms cancel). One PyTorch thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu.ops.pallas import fallback
from planetmodel_sph_tpu.ops.pallas import groups2 as jk
from planetmodel_sph_tpu_torch.ops.cuda import groups2 as tk
from test_torch_groups2 import (B, G, S, S2, _case, _close, _cols,
                                _grav_inputs, _j, _np, _t)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the tight tolerances here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pass2_inputs(seed, mode, av, balsara, merged, receiver, g=G, b=B, s=S,
                  s2=S2, energy=False):
    """(nv, tgt cols, src rows, p2p kw) of one pass-2 call under the flags,
    with approaching and receding pairs when av."""
    nv, (tx, ty, tz, tih), (sx, sy, sz, sih, sm) = _case(seed, g, b, s)
    rng = np.random.default_rng(seed + 200)
    u = lambda lo, hi, shape: rng.uniform(lo, hi, shape).astype(np.float32)
    tgt = [tx, ty, tz, tih]
    if mode != "reference_asymmetric":
        tgt.append(u(0.5, 2.0, tx.shape))
    src = [sx, sy, sz, sih, sm, u(0.5, 2.0, (g, s))]
    if av:
        tgt += [u(-1, 1, tx.shape) for _ in range(3)]
        tgt += [1.0 / tih, u(0.5, 1.5, tx.shape), u(0.5, 2.0, tx.shape)]
        src += [u(-1, 1, (g, s)) for _ in range(3)]
        src += [1.0 / sih, u(0.5, 1.5, (g, s)), u(0.5, 2.0, (g, s))]
        if balsara:
            tgt.append(u(0.0, 1.0, tx.shape))
            src.append(u(0.0, 1.0, (g, s)))
    elif energy:
        # the energy equation without viscosity: the three velocities only
        tgt += [u(-1, 1, tx.shape) for _ in range(3)]
        src += [u(-1, 1, (g, s)) for _ in range(3)]
    kw = {}
    if merged:
        nvp, _, (px, py, pz, pih, pm) = _case(seed + 1, g, b, s2)
        prow = [px, py, pz, pm] if receiver else [px, py, pz, pih, pm]
        kw = dict(nv_p2p=nvp[::-1].copy(), p2p_rows=prow)
    return nv, _cols(tgt), src, kw


def _flags(mode="symmetric", sign_bug=False, av=False, balsara=False,
           grav=False, merged=False, receiver=False, energy=False):
    return dict(mode=mode, sign_bug=sign_bug, av=av, balsara=balsara,
                grav=grav, merged=merged, receiver=receiver, energy=energy)


PASS2_CASES = {
    "symmetric": _flags(),
    "asymmetric+sign_bug": _flags("reference_asymmetric", sign_bug=True),
    "grad_h+sign_bug": _flags("grad_h", sign_bug=True),
    "symmetric+av": _flags(av=True),
    "grad_h+av+balsara": _flags("grad_h", av=True, balsara=True),
    "asymmetric+sign_bug+av+balsara": _flags(
        "reference_asymmetric", sign_bug=True, av=True, balsara=True),
    "symmetric+fused": _flags(grav=True),
    "symmetric+fused+receiver": _flags(grav=True, receiver=True),
    "symmetric+merged+receiver": _flags(grav=True, merged=True,
                                        receiver=True),
    "grad_h+av+balsara+merged": _flags("grad_h", av=True, balsara=True,
                                       grav=True, merged=True),
    "asymmetric+av+fused": _flags("reference_asymmetric", av=True,
                                  grav=True),
}
# the energy column: grad_h and symmetric x viscosity off/on x Balsara x
# gravity none/fused/merged
ENERGY_CASES = {
    f"{mode}{'+av' if av else ''}{'+balsara' if bal else ''}+energy"
    f"{'+' + grav if grav != 'none' else ''}": _flags(
        mode, av=av, balsara=bal, energy=True, grav=grav != "none",
        merged=grav == "merged")
    for mode in ("grad_h", "symmetric")
    for av, bal in ((False, False), (True, False), (True, True))
    for grav in ("none", "fused", "merged")
}
ENERGY_CASES["symmetric+sign_bug+av+energy"] = _flags(
    sign_bug=True, av=True, energy=True)
PASS2_CASES.update(ENERGY_CASES)


def _check_pass2(out, ref, f):
    """gp(3) [av(3)] [dc(4)] [du] [phi g(3) nd]: sums of cancelling terms
    get an atol of 1e-6 of their group's scale."""
    ref = _np(ref)
    assert len(out) == len(ref) == 3 + 3 * f["av"] + 4 * f["balsara"] \
        + f["energy"] + 5 * f["grav"]
    k = 0
    groups = [3] + ([3] if f["av"] else []) + ([4] if f["balsara"] else []) \
        + ([1] if f["energy"] else [])
    for n in groups:
        scale = max(np.abs(r).max() for r in ref[k:k + n])
        assert scale > 0.0                  # the sums are not vacuous
        for j in range(k, k + n):
            _close(out[j], ref[j], 1e-5, 1e-6 * scale)
        k += n
    if f["grav"]:
        _close(out[k], ref[k], 3e-5)
        gscale = max(np.abs(r).max() for r in ref[k + 1:k + 4])
        for j in range(k + 1, k + 4):
            _close(out[j], ref[j], 1e-5, 1e-6 * gscale)
        _close(out[k + 4], ref[k + 4], 0)
        assert out[k + 4].dtype == torch.int32


def _run_pass2(seed, f, jax_fn, **size):
    nv, tgt, src, pkw = _pass2_inputs(seed, f["mode"], f["av"],
                                      f["balsara"], f["merged"],
                                      f["receiver"], energy=f["energy"],
                                      **size)
    kw = dict(mode=f["mode"], av=f["av"], balsara=f["balsara"],
              energy=f["energy"],
              sign_bug=f["sign_bug"], av_alpha=1.0, av_beta=2.0,
              grav=f["grav"], receiver_soft=f["receiver"], g_const=0.7)
    jkw = {k: (jnp.asarray(v) if k == "nv_p2p" else _j(v))
           for k, v in pkw.items()}
    tkw = {k: (torch.from_numpy(v) if k == "nv_p2p" else _t(v))
           for k, v in pkw.items()}
    ref = jax_fn(jnp.asarray(nv), _j(tgt), _j(src), **kw, **jkw)
    b = size.get("b", B)
    out = tk.pass2(torch.from_numpy(nv), _t(tgt), _t(src), b=b, **kw, **tkw)
    _check_pass2(out, ref, f)


@pytest.mark.parametrize("case", sorted(PASS2_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_pass2_modes_plain_match_jax(case, seed):
    _run_pass2(seed, PASS2_CASES[case], fallback.pass2)


@pytest.mark.parametrize("case", [
    "symmetric", "asymmetric+sign_bug", "grad_h+av+balsara",
    "symmetric+fused+receiver", "symmetric+merged+receiver",
    "grad_h+energy+merged", "symmetric+av+energy"])
def test_pass2_modes_match_pallas_interpret(case, monkeypatch):
    monkeypatch.setenv("PSPH_FORCE_INTERPRET", "1")
    size = dict(g=2, b=8, s=256, s2=128)
    body = lambda *a, **kw: jk.pass2(*a, b=8, chunk=128, **kw)
    _run_pass2(5, PASS2_CASES[case], body, **size)


def test_pass2_viscosity_ignores_slots_past_nv():
    """Slots past nv may hold anything (the gather pads them with zeros,
    so rhobar and the mu denominator can be 0 there): the viscosity sums
    must not see them."""
    f = PASS2_CASES["grad_h+av+balsara"]
    nv, tgt, src, _ = _pass2_inputs(3, f["mode"], True, True, False, False)
    kw = dict(b=B, mode=f["mode"], av=True, balsara=True, av_alpha=1.0,
              av_beta=2.0)
    ref = tk.pass2(torch.from_numpy(nv), _t(tgt), _t(src), **kw)
    dirty = [r.copy() for r in src]
    tgt0 = [t.copy() for t in tgt]
    for gi, n in enumerate(nv):
        for r in dirty[6:]:
            r[gi, n:] = 0.0                  # h = cs = rho = 0 past nv
    tgt0[8][:B] = 0.0                        # and targets with h = 0 there
    tgt0[10][:B] = 0.0                       # (group 0 has nv = 0) and rho 0
    out = tk.pass2(torch.from_numpy(nv), _t(tgt0), _t(dirty), **kw)
    for o, r in zip(out, ref):
        assert bool(torch.isfinite(o).all())
        np.testing.assert_array_equal(o.numpy()[B:], r.numpy()[B:])
    assert all(float(o[:B].abs().max()) == 0.0 for o in out)


@pytest.mark.parametrize("seed", [0, 1])
def test_pass1_sym_plain_matches_jax(seed):
    nv, tgt, src = _case(seed)
    ref = _np(fallback.pass1_sym(jnp.asarray(nv), _j(_cols(tgt)), _j(src)))
    out = tk.pass1_sym(torch.from_numpy(nv), _t(_cols(tgt)), _t(src), b=B)
    _close(out[0], ref[0], 2e-6)
    _close(out[1], ref[1], 0)
    assert out[1].dtype == torch.int32 and int(out[1].sum()) > 0


@pytest.mark.parametrize("receiver", [False, True],
                         ids=["min_h", "receiver_h"])
@pytest.mark.parametrize("seed", [0, 1])
def test_p2p_plain_matches_jax(seed, receiver):
    nv, tgt, src = _case(seed)
    rows = [src[0], src[1], src[2], src[4]] if receiver else src
    ref = _np(fallback.p2p(jnp.asarray(nv), _j(_cols(tgt)), _j(rows),
                           receiver_soft=receiver, g_const=1.3))
    out = tk.p2p(torch.from_numpy(nv), _t(_cols(tgt)), _t(rows), b=B,
                 receiver_soft=receiver, g_const=1.3)
    _close(out[0], ref[0], 3e-5)
    gscale = max(np.abs(r).max() for r in ref[1:4])
    for k in range(1, 4):
        _close(out[k], ref[k], 1e-5, 1e-6 * gscale)
    _close(out[4], ref[4], 0)
    # the self pair of each group's first target: counted, and phi holds
    # its finite -2.4 g m / a
    assert int(out[4][B]) == int((src[4][1, :nv[1]] > 0).sum())


def _near_rows(seed, receiver, g=G, b=B, sp=S2):
    nvp, _, (px, py, pz, pih, pm) = _case(seed + 50, g, b, sp)
    return nvp, ([px, py, pz, pm] if receiver else [px, py, pz, pih, pm])


@pytest.mark.parametrize("receiver", [False, True],
                         ids=["min_h", "receiver_h"])
@pytest.mark.parametrize("nm", [10, 4])
def test_gravity_fused_near_tier_plain_matches_jax(nm, receiver):
    nv_ring, tgt, ring, far, accept = _grav_inputs(3, nm)
    nvp, prow = _near_rows(3, receiver)
    ref = _np(fallback.gravity_fused(
        jnp.asarray(nvp), jnp.asarray(nv_ring), _j(tgt), _j(prow), _j(ring),
        _j(far), jnp.asarray(accept), receiver_soft=receiver, g_const=1.3))
    out = tk.gravity_fused(
        torch.from_numpy(nv_ring), _t(tgt), _t(ring), _t(far),
        torch.from_numpy(accept), b=B, g_const=1.3,
        nv_p2p=torch.from_numpy(nvp), p2p_rows=_t(prow),
        receiver_soft=receiver)
    _close(out[0], ref[0], 3e-5)
    gscale = max(np.abs(r).max() for r in ref[1:4])
    for k in range(1, 4):
        _close(out[k], ref[k], 1e-5, 1e-6 * gscale)
    _close(out[4], ref[4], 0)
    _close(out[5], ref[5], 0)
    # two separate counts: the near tier's in n_direct, ring + far in
    # n_approx, neither empty
    assert int(out[4].sum()) > 0 and int(out[5].sum()) > 0


def _blk_rows(seed, nm, g=G, sb=S2):
    """A block-tier window: the ring's fields, ragged nv, some m = 0."""
    rng = np.random.default_rng(seed + 70)
    m = rng.uniform(0.5, 2.0, (g, sb)).astype(np.float32)
    m[:, 2::5] = 0.0
    c = [(rng.uniform(-1, 1, (g, sb)) * 8.0
          + 12.0 * np.sign(rng.uniform(-1, 1, (g, sb)))).astype(np.float32)
         for _ in range(3)]
    q = [rng.normal(0, 0.3, (g, sb)).astype(np.float32) for _ in range(6)]
    nv = np.array([sb, 0, sb // 2 + 1][:g], np.int32)
    return nv, ([m] + c + q)[:nm]


@pytest.mark.parametrize("near", [False, True], ids=["far_only", "near"])
@pytest.mark.parametrize("nm", [10, 4])
def test_gravity_fused_blk_tier_plain_matches_jax(nm, near):
    """The supergroup block tier: a third windowed moment sweep whose
    entries count into n_approx, far-only and with the near tier."""
    nv_ring, tgt, ring, far, accept = _grav_inputs(4, nm)
    nvb, brow = _blk_rows(4, nm)
    nvp, prow = _near_rows(4, False)
    ref = _np(fallback.gravity_fused(
        jnp.asarray(nvp) if near else None, jnp.asarray(nv_ring), _j(tgt),
        _j(prow) if near else None, _j(ring), _j(far), jnp.asarray(accept),
        receiver_soft=False, g_const=1.3, nv_blk=jnp.asarray(nvb),
        blk_rows=_j(brow), has_p2p=near))
    nkw = dict(nv_p2p=torch.from_numpy(nvp), p2p_rows=_t(prow)) if near \
        else {}
    args = (torch.from_numpy(nv_ring), _t(tgt), _t(ring), _t(far),
            torch.from_numpy(accept))
    out = tk.gravity_fused(*args, b=B, g_const=1.3,
                           nv_blk=torch.from_numpy(nvb), blk_rows=_t(brow),
                           **nkw)
    _close(out[0], ref[0], 3e-5)
    gscale = max(np.abs(r).max() for r in ref[1:4])
    for k in range(1, 4):
        _close(out[k], ref[k], 1e-5, 1e-6 * gscale)
    _close(out[4], ref[4], 0)
    _close(out[5], ref[5], 0)
    # the tier's live entries are counted, and only into n_approx
    bare = tk.gravity_fused(*args, b=B, g_const=1.3, **nkw)
    live = (brow[0] > 0) & (np.arange(S2)[None, :] < nvb[:, None])
    np.testing.assert_array_equal(
        (out[5] - bare[5]).numpy().reshape(G, B),
        np.repeat(live.sum(axis=1)[:, None], B, axis=1))
    np.testing.assert_array_equal(out[4].numpy(), bare[4].numpy())
    assert int(live.sum()) > 0


def test_gravity_fused_blk_tier_matches_pallas_interpret(monkeypatch):
    """The has_blk branch of the Pallas body itself."""
    monkeypatch.setenv("PSPH_FORCE_INTERPRET", "1")
    g, b, chunk = 2, 8, 128
    gnv, gtgt, ring, far, accept = _grav_inputs(7, 10, g, b, 128, 256)
    nvb, brow = _blk_rows(7, 10, g, 128)
    for near in (False, True):
        nvp, prow = _near_rows(7, False, g, b, 128)
        nvp = np.minimum(nvp[:g], 128).astype(np.int32)
        ref = _np(jk.gravity_fused(
            jnp.asarray(nvp) if near else None, jnp.asarray(gnv), _j(gtgt),
            _j(prow) if near else None, _j(ring), _j(far),
            jnp.asarray(accept), b=b, chunk=chunk, receiver_soft=False,
            g_const=1.0, nv_blk=jnp.asarray(nvb), blk_rows=_j(brow),
            has_p2p=near))
        nkw = dict(nv_p2p=torch.from_numpy(nvp), p2p_rows=_t(prow)) \
            if near else {}
        out = tk.gravity_fused(
            torch.from_numpy(gnv), _t(gtgt), _t(ring), _t(far),
            torch.from_numpy(accept), b=b, nv_blk=torch.from_numpy(nvb),
            blk_rows=_t(brow), **nkw)
        _close(out[0], ref[0], 3e-5)
        gscale = max(np.abs(r).max() for r in ref[1:4])
        for k in range(1, 4):
            _close(out[k], ref[k], 1e-4, 1e-6 * gscale)
        _close(out[4], ref[4], 0)
        _close(out[5], ref[5], 0)


def test_pass2_energy_column_sits_before_gravity():
    """du is one more output after the Balsara sums and before the gravity
    outputs, complete as summed; the other outputs do not move."""
    f = PASS2_CASES["grad_h+av+balsara+energy+merged"]
    nv, tgt, src, pkw = _pass2_inputs(2, f["mode"], True, True, True, False,
                                      energy=True)
    kw = dict(b=B, mode="grad_h", av=True, balsara=True, av_alpha=1.0,
              av_beta=2.0, grav=True, nv_p2p=torch.from_numpy(pkw["nv_p2p"]),
              p2p_rows=_t(pkw["p2p_rows"]))
    with_e = tk.pass2(torch.from_numpy(nv), _t(tgt), _t(src), energy=True,
                      **kw)
    without = tk.pass2(torch.from_numpy(nv), _t(tgt), _t(src), **kw)
    assert len(with_e) == len(without) + 1 == 16
    for a, c in zip(with_e[:10] + with_e[11:], without):
        assert torch.equal(a, c)
    du = with_e[10]
    assert du.dtype == torch.float32 and float(du.abs().max()) > 0.0
    assert float(du[:B].abs().max()) == 0.0           # group 0 has nv = 0


def test_new_kernels_match_pallas_interpret(monkeypatch):
    """pass1_sym, p2p (both softenings) and gravity_fused with the near
    tier through the Pallas bodies themselves."""
    monkeypatch.setenv("PSPH_FORCE_INTERPRET", "1")
    g, b, s, chunk = 2, 8, 256, 128
    nv, tgt, src = _case(5, g, b, s)
    nv = np.array([s // 2 + 3, s], np.int32)
    jnv, tnv = jnp.asarray(nv), torch.from_numpy(nv)

    ref = _np(jk.pass1_sym(jnv, _j(_cols(tgt)), _j(src), b=b, chunk=chunk))
    out = tk.pass1_sym(tnv, _t(_cols(tgt)), _t(src), b=b)
    _close(out[0], ref[0], 2e-6)
    _close(out[1], ref[1], 0)

    for receiver in (False, True):
        rows = [src[0], src[1], src[2], src[4]] if receiver else src
        ref = _np(jk.p2p(jnv, _j(_cols(tgt)), _j(rows), b=b, chunk=chunk,
                         receiver_soft=receiver, g_const=0.9))
        out = tk.p2p(tnv, _t(_cols(tgt)), _t(rows), b=b,
                     receiver_soft=receiver, g_const=0.9)
        scale = max(np.abs(r).max() for r in ref[:4])
        for k in range(4):
            _close(out[k], ref[k], 3e-5, 1e-6 * scale)
        _close(out[4], ref[4], 0)

        gnv, gtgt, ring, far, accept = _grav_inputs(7, 10, g, b, 128, 256)
        nvp, prow = _near_rows(7, receiver, g, b, 128)
        nvp = np.minimum(nvp[:g], 128).astype(np.int32)
        ref = _np(jk.gravity_fused(
            jnp.asarray(nvp), jnp.asarray(gnv), _j(gtgt), _j(prow),
            _j(ring), _j(far), jnp.asarray(accept), b=b, chunk=chunk,
            receiver_soft=receiver, g_const=1.0))
        out = tk.gravity_fused(
            torch.from_numpy(gnv), _t(gtgt), _t(ring), _t(far),
            torch.from_numpy(accept), b=b, nv_p2p=torch.from_numpy(nvp),
            p2p_rows=_t(prow), receiver_soft=receiver)
        _close(out[0], ref[0], 3e-5)
        gscale = max(np.abs(r).max() for r in ref[1:4])
        for k in range(1, 4):
            _close(out[k], ref[k], 1e-4, 1e-6 * gscale)
        _close(out[4], ref[4], 0)
        _close(out[5], ref[5], 0)


def test_new_wrappers_refuse_bad_arguments():
    nv, tgt, src = _case(0)
    tnv, cols, rows = torch.from_numpy(nv), _t(_cols(tgt)), _t(src)
    with pytest.raises(ValueError, match="5 source rows"):
        tk.pass1_sym(tnv, cols, rows[:4], b=B)
    with pytest.raises(ValueError, match="4 source rows"):
        tk.p2p(tnv, cols, rows, b=B, receiver_soft=True)
    with pytest.raises(ValueError, match="mode"):
        tk.pass2(tnv, cols, rows, b=B, mode="sym")
    with pytest.raises(ValueError, match="balsara needs av"):
        tk.pass2(tnv, cols, rows, b=B, balsara=True)
    with pytest.raises(ValueError, match="needs grav"):
        tk.pass2(tnv, cols + [cols[0]], rows + [rows[0]], b=B,
                 nv_p2p=tnv, p2p_rows=rows)
    # reference_asymmetric takes no tc column
    with pytest.raises(ValueError, match="4 target columns"):
        tk.pass2(tnv, cols + [cols[0]], rows + [rows[0]], b=B,
                 mode="reference_asymmetric")
    # the energy equation has no reference_asymmetric form, and without
    # viscosity it takes the three velocities and nothing else
    with pytest.raises(ValueError, match="momentum-conserving"):
        tk.pass2(tnv, cols, rows + [rows[0]], b=B, energy=True,
                 mode="reference_asymmetric")
    with pytest.raises(ValueError, match="8 target columns, 9 SPH rows"):
        tk.pass2(tnv, cols + [cols[0]], rows + [rows[0]], b=B, energy=True)
    # the block tier takes as many moment fields as the ring
    ring = [rows[4], rows[0], rows[1], rows[2]]
    far = [r[:1].contiguous() for r in ring]
    with pytest.raises(ValueError, match="moment fields for every tier"):
        tk.gravity_fused(tnv, cols, ring, far, rows[4], b=B, nv_blk=tnv,
                         blk_rows=ring[:3])


def test_cpu_tensors_launch_nothing():
    tk.reset_launches()
    nv, tgt, src = _case(0)
    tk.pass1_sym(torch.from_numpy(nv), _t(_cols(tgt)), _t(src), b=B)
    tk.p2p(torch.from_numpy(nv), _t(_cols(tgt)), _t(src), b=B,
           receiver_soft=False)
    assert set(tk.LAUNCHES) >= {"pass1_sym", "p2p", "pass2",
                                "gravity_fused"}
    assert all(v == 0 for v in tk.LAUNCHES.values())
