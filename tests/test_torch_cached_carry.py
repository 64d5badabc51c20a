"""The cached-step API, unsorted chunks and the cached dense step, the port
against the JAX package (mirroring ``tests/test_cached.py``):

- ``init_carry`` + 8 ``step_carry`` calls on the grid + tree pipeline (a
  rebuild, with the relaxation of h, every 4 steps) match JAX's;
- ``run_info`` with ``sorted_chunks=False`` (two chunks of 4 and a
  remainder, a Morton sort reused over 8 steps) matches JAX's, and matches
  the port's own sorted run at the reference's tolerance (rtol 2e-5, atol
  1e-6, integer fields equal);
- the cached dense step (``rebuild_every=4`` on dense neighbours) with
  direct gravity, with tree gravity from the cached structure, and under
  grad-h with tree gravity and the centre-of-mass correction, matches
  JAX's.

Both packages start from the same initial conditions (made by the JAX
package, handed over as numpy arrays). pos and vel agree within rtol 1e-4
(atol 1e-4 of the field's scale), h and rho within rtol 1e-4, counts and
overflow exactly.
"""

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu.models import planet as jp
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.models import planet as tp
from planetmodel_sph_tpu_torch.ops.cuda import launch

GRID = dict(n=512, radius=12.0, particle_radius=2.5, neighbor_mode="grid",
            gravity_solver="tree", adaptive_h=True, rebuild_every=4)
COUNTS = ("n_neighbors", "n_direct", "n_approx")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One thread keeps the exact counts here deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(kw, prime=True):
    """(JAX state, port state) from the JAX package's initial conditions,
    each primed by its own package under the uncached step."""
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    st0 = jics.jupiter(jcfg)
    arrays = {k: np.asarray(v) for k, v in vars(st0).items()}
    out0 = tstate.from_numpy(arrays, device="cpu")
    if prime:
        uncached = dict(rebuild_every=1, respa_every=1)
        st0 = jax.jit(lambda s: jp.prime(s, jcfg.replace(**uncached)))(st0)
        out0 = tp.prime(out0, tcfg.replace(**uncached))
    return jcfg, tcfg, st0, out0


def _close(a, b, rtol, scale_atol=0.0, name=""):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, err_msg=name,
                               atol=scale_atol * np.abs(b).max())


def _match(out, ref):
    _close(out.pos, ref.pos, 1e-4, 1e-4, "pos")
    _close(out.vel, ref.vel, 1e-4, 1e-4, "vel")
    _close(out.h, ref.h, 1e-4, name="h")
    _close(out.rho, ref.rho, 1e-4, 1e-6, "rho")
    for name in COUNTS:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for k in vars(out):
        assert bool(torch.isfinite(getattr(out, k).float()).all()), k


def test_init_carry_and_step_carry_match_jax():
    jcfg, tcfg, st0, out0 = _start(GRID, prime=False)
    ref = jax.jit(lambda s: jp.init_carry(s, jcfg))(st0)
    step = jax.jit(lambda c: jp.step_carry(c, jcfg))
    c = tp.init_carry(out0, tcfg)
    assert c.tick == 0 and c.st is not None
    _close(c.state.rho, ref.state.rho, 1e-5, name="init rho")
    for _ in range(8):
        ref = step(ref)
        c = tp.step_carry(c, tcfg)
    assert c.tick == int(ref.tick) == 8
    _match(c.state, ref.state)
    np.testing.assert_array_equal(c.st.sph_idx.numpy(),
                                  np.asarray(ref.st.sph_idx))
    assert not torch.equal(c.state.pos, out0.pos)


def test_step_carry_rebuilds_on_its_cadence(monkeypatch):
    _, tcfg, _, out0 = _start(dict(GRID, n=256), prime=False)
    builds = []
    real = tp._build_caches
    monkeypatch.setattr(tp, "_build_caches",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    c = tp.init_carry(out0, tcfg)
    seen = [c.st]
    for _ in range(9):
        c = tp.step_carry(c, tcfg)
        seen.append(c.st)
    # init, then ticks 0, 4 and 8 rebuild; the steps between keep it
    assert len(builds) == 4
    assert seen[1] is not seen[0] and seen[2] is seen[1]
    assert seen[5] is not seen[4] and seen[9] is not seen[8]


@pytest.fixture(scope="module")
def unsorted_runs():
    kw = dict(GRID, sort_every=8)
    jcfg, tcfg, st0, out0 = _start(dict(kw, sorted_chunks=False))
    ref, info_ref = jp.run_info(st0, jcfg, 10)
    jax.block_until_ready(ref)
    out, info = tp.run_info(out0, tcfg, 10)
    srt, info_srt = tp.run_info(out0, tcfg.replace(sorted_chunks=True), 10)
    return (ref, info_ref), (out, info), (srt, info_srt)


def test_unsorted_chunks_match_jax(unsorted_runs):
    (ref, info_ref), (out, info), _ = unsorted_runs
    _match(out, ref)
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_ref.items()}


def test_unsorted_chunks_match_the_sorted_run(unsorted_runs):
    _, (out, info), (srt, info_srt) = unsorted_runs
    for k in vars(out):
        a, b = getattr(out, k), getattr(srt, k)
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_srt.items()}


DENSE = dict(n=256, radius=10.0, particle_radius=2.2, neighbor_mode="dense",
             adaptive_h=True, rebuild_every=4)
DENSE_CASES = {
    "direct": dict(DENSE, gravity_solver="direct"),
    "tree": dict(DENSE, gravity_solver="tree", nbr_group_level=2,
                 nbr_group_size=32, nbr_sub=16),
    "gradh_tree_com": dict(DENSE, gravity_solver="tree", nbr_group_level=2,
                           nbr_group_size=32, nbr_sub=16,
                           grad_p_mode="grad_h", h_mode="newton",
                           grav_com_correction=True),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_cached_dense_step_matches_jax(case):
    jcfg, tcfg, st0, out0 = _start(DENSE_CASES[case])
    ref, info_ref = jp.run_info(st0, jcfg, 8)
    launch.reset_launches()
    out, info = tp.run_info(out0, tcfg, 8)
    _match(out, ref)
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_ref.items()} == \
        {"nbr_overflow": 0, "tree_overflow": 0}
    assert all(v == 0 for v in launch.LAUNCHES.values())   # CPU: plain
    if tcfg.gravity_solver == "tree":
        assert int(out.n_approx.sum()) > 0
    # the cached runs are not the uncached step: h is relaxed only at the
    # chunk boundaries
    unc, _ = tp.run_info(out0, tcfg.replace(rebuild_every=1), 8)
    assert not torch.equal(unc.h, out.h)


def test_dense_chunk_keeps_no_structure_without_the_tree():
    _, tcfg, _, out0 = _start(DENSE_CASES["direct"])
    assert tp._build_caches(out0.pos, out0.h, out0.mass, out0.vel,
                            tcfg) is None
    _, info, groups = tp.run_chunk_cached(out0, tcfg, 2, return_groups=True)
    assert groups is None and int(info["nbr_overflow"]) == 0
