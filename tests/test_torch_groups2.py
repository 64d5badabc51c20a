"""The port's windowed kernels (plain PyTorch versions) against the JAX
package's sweeps, on the same numpy inputs.

The JAX side runs as its own suite runs it on the CPU: through
``ops/pallas/fallback.py``, and in one tiny case per kernel through the
Pallas bodies themselves in interpret mode (PSPH_FORCE_INTERPRET=1),
including the merged residual-P2P branch of pass 2. The inputs cover
ragged nv, m=0 padding slots, self pairs and both sides of q=1, q=2 and
the Dyer-Ip x=1 edge. Tolerances are those of tests/test_structure.py:
rho rtol 2e-6, gradients rtol 1e-4 atol 1e-6, phi rtol 3e-5; counts and
the filter mask exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu.ops.pallas import fallback
from planetmodel_sph_tpu.ops.pallas import groups2 as jk
from planetmodel_sph_tpu_torch.ops.cuda import groups2 as tk

G, B, S, S2 = 3, 8, 256, 128
H = 0.5          # target smoothing length of the edge-case targets


def _case(seed, g=G, b=B, s=S):
    """Targets [g*b] and source rows [g, s] with the edge cases planted."""
    rng = np.random.default_rng(seed)
    tx, ty, tz = (rng.uniform(-1.5, 1.5, g * b).astype(np.float32)
                  for _ in range(3))
    th = rng.uniform(0.3, 0.8, g * b).astype(np.float32)
    sx, sy, sz = (rng.uniform(-1.5, 1.5, (g, s)).astype(np.float32)
                  for _ in range(3))
    sh = rng.uniform(0.3, 0.8, (g, s)).astype(np.float32)
    sm = rng.uniform(0.5, 1.5, (g, s)).astype(np.float32)
    sm[:, 5::7] = 0.0                       # m = 0 padding slots
    for gi in range(g):
        t = gi * b
        tx[t], ty[t], tz[t], th[t] = 0.0, 0.0, 0.0, H
        # self pair of target t, and of target t+1
        sx[gi, 0], sy[gi, 0], sz[gi, 0], sh[gi, 0] = 0.0, 0.0, 0.0, H
        sx[gi, 1], sy[gi, 1], sz[gi, 1] = tx[t + 1], ty[t + 1], tz[t + 1]
        sh[gi, 1] = th[t + 1]
        # q = 1 and q = 2 exactly (r = h, 2h along x) and just either side
        for j, r in enumerate((H, 2 * H, H * (1 - 1e-6), H * (1 + 1e-6),
                               2 * H * (1 - 1e-6), 2 * H * (1 + 1e-6))):
            sx[gi, 2 + j], sy[gi, 2 + j], sz[gi, 2 + j] = r, 0.0, 0.0
            sh[gi, 2 + j] = H                # x = r/h: the Dyer-Ip edge
    nv = np.array([0, s // 2 + 3, s][:g], np.int32)
    return (nv, [tx, ty, tz, 1.0 / th], [sx, sy, sz, 1.0 / sh, sm])


def _cols(xs):
    return [x.reshape(-1, 1) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _np(xs):
    return [np.asarray(x) for x in xs]


def _close(a, b, rtol, atol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iub" or b.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _filter_inputs(seed, **kw):
    nv, (tx, ty, tz, _), (sx, sy, sz, sih, sm) = _case(seed, **kw)
    rng = np.random.default_rng(seed + 100)
    g, s = sx.shape
    tc = (2.0 * rng.uniform(0.1, 0.4, tx.shape)).astype(np.float32)
    tsk = rng.uniform(0.0, 0.05, tx.shape).astype(np.float32)
    sc = (2.0 * rng.uniform(0.1, 0.4, (g, s))).astype(np.float32)
    ssk = rng.uniform(0.0, 0.05, (g, s)).astype(np.float32)
    return nv, _cols([tx, ty, tz, tc, tsk]), [sx, sy, sz, sc, ssk, sm]


def _pass2_inputs(seed, g=G, b=B, s=S, s2=S2):
    nv, (tx, ty, tz, tih), (sx, sy, sz, sih, sm) = _case(seed, g, b, s)
    rng = np.random.default_rng(seed + 200)
    tc = rng.uniform(0.5, 2.0, tx.shape).astype(np.float32)
    scc = rng.uniform(0.5, 2.0, (g, s)).astype(np.float32)
    nvp, _, (px, py, pz, pih, pm) = _case(seed + 1, g, b, s2)
    return (nv, _cols([tx, ty, tz, tih, tc]), [sx, sy, sz, sih, sm, scc],
            nvp[::-1].copy(), [px, py, pz, pih, pm])


def _grav_inputs(seed, nm, g=G, b=B, sr=S, nbpad=384):
    rng = np.random.default_rng(seed)
    nv, (tx, ty, tz, tih), _ = _case(seed, g, b, sr)
    nv_ring = np.minimum(nv, sr - 10).astype(np.int32)

    def moments(shape):
        m = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        m[..., 3::5] = 0.0
        c = [rng.uniform(-1, 1, shape).astype(np.float32) * 8.0
             + 10.0 * np.sign(rng.uniform(-1, 1, shape)).astype(np.float32)
             for _ in range(3)]
        q = [rng.normal(0, 0.3, shape).astype(np.float32) for _ in range(6)]
        return ([m] + c + q)[:nm]

    ring = moments((g, sr))
    far = moments((1, nbpad))
    # an entry at r ~ 0 of a target that the mask switches off: its
    # quadrupole powers overflow unless the mask multiplies first
    far[1][0, 7], far[2][0, 7], far[3][0, 7] = tx[0], ty[0], tz[0]
    accept = (rng.uniform(0, 1, (g, nbpad)) < 0.6).astype(np.float32)
    accept[:, 7] = 0.0
    return nv_ring, _cols([tx, ty, tz, tih]), ring, far, accept


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_sph_plain_matches_jax(seed):
    nv, tgt, src = _filter_inputs(seed)
    ref = fallback.filter_sph(jnp.asarray(nv), _j(tgt), _j(src))
    out = tk.filter_sph(torch.from_numpy(nv), _t(tgt), _t(src), b=B)
    assert out.shape == (G, S) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.numpy()[1].sum() > 0            # the mask is not trivial


@pytest.mark.parametrize("seed", [0, 1])
def test_pass1_gradh_plain_matches_jax(seed):
    nv, tgt, src = _case(seed)
    rows = [src[0], src[1], src[2], src[4]]
    ref = fallback.pass1_gradh(jnp.asarray(nv), _j(_cols(tgt)), _j(rows))
    out = tk.pass1_gradh(torch.from_numpy(nv), _t(_cols(tgt)), _t(rows),
                         b=B)
    rho, nn, xi = _np(ref)
    _close(out[0], rho, 2e-6)
    _close(out[1], nn, 0)
    _close(out[2], xi, 1e-4, 1e-6)
    assert out[1].dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1])
def test_pass2_merged_plain_matches_jax(seed):
    nv, tgt, src, nvp, prow = _pass2_inputs(seed)
    g_const = 0.7
    ref = fallback.pass2(
        jnp.asarray(nv), _j(tgt), _j(src), mode="grad_h", av=False,
        energy=False, balsara=False, sign_bug=False, av_alpha=0.0,
        av_beta=0.0, grav=True, receiver_soft=False, g_const=g_const,
        nv_p2p=jnp.asarray(nvp), p2p_rows=_j(prow))
    out = tk.pass2(torch.from_numpy(nv), _t(tgt), _t(src), b=B,
                   nv_p2p=torch.from_numpy(nvp), p2p_rows=_t(prow),
                   g_const=g_const)
    ref = _np(ref)
    scale = max(np.abs(r).max() for r in ref[:3])
    for k in range(3):                                   # grad P
        _close(out[k], ref[k], 1e-4, 1e-6 * scale)
    _close(out[3], ref[3], 3e-5)                         # phi
    gscale = max(np.abs(r).max() for r in ref[4:7])
    for k in range(4, 7):                                # grad phi
        _close(out[k], ref[k], 1e-4, 1e-6 * gscale)
    _close(out[7], ref[7], 0)                            # n_direct


@pytest.mark.parametrize("nm", [10, 4])
def test_gravity_fused_plain_matches_jax(nm):
    nv_ring, tgt, ring, far, accept = _grav_inputs(3, nm)
    ref = fallback.gravity_fused(
        None, jnp.asarray(nv_ring), _j(tgt), None, _j(ring), _j(far),
        jnp.asarray(accept), receiver_soft=False, g_const=1.3,
        has_p2p=False)
    out = tk.gravity_fused(torch.from_numpy(nv_ring), _t(tgt), _t(ring),
                           _t(far), torch.from_numpy(accept), b=B,
                           g_const=1.3)
    ref = _np(ref)
    assert all(np.isfinite(np.asarray(o)).all() for o in out[:4])
    _close(out[0], ref[0], 3e-5)
    gscale = max(np.abs(r).max() for r in ref[1:4])
    for k in range(1, 4):
        _close(out[k], ref[k], 1e-4, 1e-6 * gscale)
    _close(out[4], ref[4], 0)
    _close(out[5], ref[5], 0)


def test_plain_versions_match_pallas_interpret(monkeypatch):
    """One tiny case per kernel through the Pallas bodies themselves."""
    monkeypatch.setenv("PSPH_FORCE_INTERPRET", "1")
    g, b, s, chunk = 2, 8, 256, 128
    nv, tgt, src = _case(5, g, b, s)
    nv = np.array([s // 2 + 3, s], np.int32)
    jnv, tnv = jnp.asarray(nv), torch.from_numpy(nv)

    rows = [src[0], src[1], src[2], src[4]]
    ref = _np(jk.pass1_gradh(jnv, _j(_cols(tgt)), _j(rows), b=b,
                             chunk=chunk))
    out = tk.pass1_gradh(tnv, _t(_cols(tgt)), _t(rows), b=b)
    _close(out[0], ref[0], 2e-6)
    _close(out[1], ref[1], 0)
    _close(out[2], ref[2], 1e-4, 1e-6)

    fnv, ftgt, fsrc = _filter_inputs(5, g=g, b=b, s=s)
    ref = jk.filter_sph(jnp.asarray(fnv), _j(ftgt), _j(fsrc), b=b,
                        chunk=chunk)
    out = tk.filter_sph(torch.from_numpy(fnv), _t(ftgt), _t(fsrc), b=b)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    pnv, ptgt, psrc, pnvp, prow = _pass2_inputs(6, g, b, s, 128)
    ref = _np(jk.pass2(
        jnp.asarray(pnv), _j(ptgt), _j(psrc), b=b, chunk=chunk,
        mode="grad_h", av=False, sign_bug=False, grav=True,
        receiver_soft=False, g_const=1.0, nv_p2p=jnp.asarray(pnvp),
        p2p_rows=_j(prow)))
    out = tk.pass2(torch.from_numpy(pnv), _t(ptgt), _t(psrc), b=b,
                   nv_p2p=torch.from_numpy(pnvp), p2p_rows=_t(prow))
    scale = max(np.abs(r).max() for r in ref[:7])
    for k in range(7):
        _close(out[k], ref[k], 1e-4, 1e-6 * scale)
    _close(out[7], ref[7], 0)

    gnv, gtgt, ring, far, accept = _grav_inputs(7, 10, g, b, 128, 256)
    ref = _np(jk.gravity_fused(
        None, jnp.asarray(gnv), _j(gtgt), None, _j(ring), _j(far),
        jnp.asarray(accept), b=b, chunk=chunk, receiver_soft=False,
        g_const=1.0, has_p2p=False))
    out = tk.gravity_fused(torch.from_numpy(gnv), _t(gtgt), _t(ring),
                           _t(far), torch.from_numpy(accept), b=b)
    _close(out[0], ref[0], 3e-5)
    gscale = max(np.abs(r).max() for r in ref[1:4])
    for k in range(1, 4):
        _close(out[k], ref[k], 1e-4, 1e-6 * gscale)
    _close(out[5], ref[5], 0)


def test_cpu_tensors_run_plain_and_count_no_launch():
    tk.reset_launches()
    nv, tgt, src = _case(0)
    rows = [src[0], src[1], src[2], src[4]]
    tk.pass1_gradh(torch.from_numpy(nv), _t(_cols(tgt)), _t(rows), b=B)
    assert all(v == 0 for v in tk.LAUNCHES.values())


def test_wrappers_refuse_bad_arguments():
    nv, tgt, src = _case(0)
    rows = _t([src[0], src[1], src[2], src[4]])
    cols = _t(_cols(tgt))
    with pytest.raises(TypeError):
        tk.pass1_gradh(torch.from_numpy(nv).long(), cols, rows, b=B)
    with pytest.raises(ValueError):
        tk.pass1_gradh(torch.from_numpy(nv), cols, rows, b=B + 1)
    bad = [rows[0].t().contiguous().t()] + rows[1:]
    with pytest.raises(ValueError):
        tk.pass1_gradh(torch.from_numpy(nv), cols, bad, b=B)
