"""The port's spline kernel and pairwise gravity terms against the JAX
package's, on a numpy grid of (r, h) that includes r = 0 and the branch
points q = 1 and q = 2. Both are the same f32 expressions in the same
order, so they are held to rtol 1e-6 (an ulp or two where a division or a
power rounds differently), with an atol of 1e-6 of the field's largest
magnitude where a branch passes through zero (W and dW at q = 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu.ops import gravity as jg
from planetmodel_sph_tpu.ops import kernels as jk
from planetmodel_sph_tpu_torch.ops import gravity as tg
from planetmodel_sph_tpu_torch.ops import kernels as tk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch's first multi-threaded CPU call in a process can round a few
    rows differently from every later call; one thread keeps the tight
    tolerances here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid():
    h = np.array([0.3, 1.0, 2.5, 7.0], np.float32)
    q = np.concatenate([[0.0, 1.0, 2.0], np.linspace(0.0, 2.6, 53),
                        np.nextafter(np.float32([1.0, 2.0]), 0),
                        np.nextafter(np.float32([1.0, 2.0]), 9)])
    r = (q[:, None] * h[None, :]).astype(np.float32)
    return r, np.broadcast_to(h, r.shape).copy()


def _close(out, ref, rtol=1e-6):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["w", "dw_dh"])
def test_value_functions_match_jax(name):
    r, h = _grid()
    out = getattr(tk, name)(torch.from_numpy(r), torch.from_numpy(h))
    _close(out, getattr(jk, name)(jnp.asarray(r), jnp.asarray(h)))


def test_w0_matches_jax():
    _, h = _grid()
    _close(tk.w0(torch.from_numpy(h)), jk.w0(jnp.asarray(h)))


@pytest.mark.parametrize("sign_bug", [False, True])
@pytest.mark.parametrize("name", ["dw_dr", "dw_dr_over_r"])
def test_derivatives_match_jax(name, sign_bug):
    r, h = _grid()
    out = getattr(tk, name)(torch.from_numpy(r), torch.from_numpy(h),
                            sign_bug)
    ref = getattr(jk, name)(jnp.asarray(r), jnp.asarray(h), sign_bug)
    assert np.isfinite(out.numpy()).all()          # r = 0 included
    _close(out, ref)


@pytest.mark.parametrize("sign_bug", [False, True])
def test_w_and_grad_matches_jax(sign_bug):
    rng = np.random.default_rng(3)
    dx = rng.normal(size=(64, 3)).astype(np.float32)
    dx[0] = 0.0
    r = np.sqrt((dx * dx).sum(-1))
    h = rng.uniform(0.4, 1.5, 64).astype(np.float32)
    w, g = tk.w_and_grad(torch.from_numpy(dx), torch.from_numpy(r),
                         torch.from_numpy(h), sign_bug)
    w_ref, g_ref = jk.w_and_grad(jnp.asarray(dx), jnp.asarray(r),
                                 jnp.asarray(h), sign_bug)
    _close(w, w_ref)
    _close(g, g_ref)


def test_interacts_matches_jax():
    r, h = _grid()
    hj = np.roll(h, 1, axis=1)
    out = tk.interacts(torch.from_numpy(r * r), torch.from_numpy(h),
                       torch.from_numpy(hj))
    ref = jk.interacts(jnp.asarray(r * r), jnp.asarray(h), jnp.asarray(hj))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _pairs():
    rng = np.random.default_rng(5)
    dx = rng.normal(size=(200, 3)).astype(np.float32) * 2.0
    dx[0] = 0.0                                    # coincident pair
    a = rng.uniform(0.5, 4.0, 200).astype(np.float32)
    dx[1] = [a[1], 0.0, 0.0]                       # r = a
    m = rng.uniform(0.0, 2.0, 200).astype(np.float32)
    m[2] = 0.0                                     # masked pair
    r = np.sqrt((dx * dx).sum(-1)).astype(np.float32)
    return dx, r, m, a


@pytest.mark.parametrize("name", ["dyer_ip", "monopole", "dyer_ip_fast"])
def test_gravity_terms_match_jax(name):
    dx, r, m, a = _pairs()
    if name == "dyer_ip":
        args = (dx, r, m, a)
    elif name == "monopole":
        args = (dx, r, m)
    else:
        args = (dx, r * r, m, (1.0 / a).astype(np.float32))
    gp, phi = getattr(tg, name)(*(torch.from_numpy(x) for x in args), 1.5)
    gp_ref, phi_ref = getattr(jg, name)(*(jnp.asarray(x) for x in args), 1.5)
    assert np.isfinite(gp.numpy()).all() and np.isfinite(phi.numpy()).all()
    _close(gp, gp_ref)
    _close(phi, phi_ref)
    assert float(phi[2]) == 0.0 and not gp[2].any()


def test_accept_bmax_matches_jax():
    r2 = np.linspace(0.0, 9.0, 50).astype(np.float32)
    b2 = np.full(50, 2.0, np.float32)
    out = tg.accept_bmax(torch.from_numpy(r2), torch.from_numpy(b2), 0.7)
    ref = jg.accept_bmax(jnp.asarray(r2), jnp.asarray(b2), 0.7)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
