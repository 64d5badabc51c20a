"""The port's data-parallel path (``parallel/mesh.py``, ``parallel/dp.py``)
on gloo ranks on the CPU against the JAX package's on its virtual CPU mesh.

Each world size (D = 2 and 4) is one spawn of D ranks that runs every
check of this file once (a module-scoped fixture); the ranks hand their
gathered results to this process, which holds them against the JAX
package's ``parallel/dp.py`` on ``make_mesh(D)`` from the same primed
state:

- ``make_run_info``, 4 steps of the tiny production stack of
  tests/test_parallel.py (sorted chunks, refine and truncation, Newton and
  tracked h, RESPA, quadrupoles, the COM correction, the fused residual
  P2P): pos and rho within rtol 1e-4 / atol 1e-4 (the port's multi-step
  bound, tests/test_torch_planet.py), the overflow info exactly;
- ``make_step``, one per-step grid + tree step with viscosity: the same
  bounds, the neighbour counts exactly;
- ``make_run_diag``: its row is ``utils.diagnostics.measure`` of the
  gathered state, exactly, and the JAX measure of the JAX step within rtol
  1e-4;
- the ``axis=`` hooks: ``current_dt`` (CFL) and ``com_correct`` over the
  ranks equal their single-set values exactly.
"""

import numpy as np
import pytest
import torch

from planetmodel_sph_tpu_torch import cli
from planetmodel_sph_tpu_torch.parallel import dp, mesh as tmesh

PROD = dict(n=512, radius=24.0, particle_radius=3.0, block_n=64,
            gravity_solver="tree", neighbor_mode="grid", rebuild_every=2,
            sort_every=4, respa_every=2, multipole_order=2,
            grad_p_mode="grad_h", h_mode="newton", h_track_margin=0.04,
            sph_refine_subblock=True, sph_refined_window=64,
            grav_com_correction=True, fuse_p2p_sph=True,
            fuse_p2p_residual=True, nbr_group_size=32, nbr_group_level=2,
            nbr_window=128, p2p_window=128, m2p_window=128)
GRID = dict(n=512, radius=24.0, particle_radius=3.0, gravity_solver="tree",
            neighbor_mode="grid", av_alpha=1.0, av_beta=2.0,
            grav_com_correction=True, nbr_group_size=32, nbr_group_level=2,
            nbr_window=128, p2p_window=128, m2p_window=128)
STEPS = 4
FIELDS = ("pos", "rho", "h", "n_neighbors")


def _rank_checks(mesh, prod, grid, q):
    """Every rank: the runs of this file on its shard; rank 0 puts the
    gathered results on `q`."""
    from planetmodel_sph_tpu_torch import config as tc, state as tstate
    from planetmodel_sph_tpu_torch.models import planet as tp
    from planetmodel_sph_tpu_torch.utils import diagnostics as tdiag
    out = {}
    cfg = tc.SimConfig(**PROD)
    loc = tmesh.shard_state(tstate.from_numpy(prod, device="cpu"), mesh)
    run, info = dp.make_run_info(cfg, mesh)(loc, STEPS)
    full = tmesh.gather_state(run, mesh)
    out["run"] = {k: getattr(full, k).numpy() for k in FIELDS}
    out["info"] = {k: int(v) for k, v in info.items()}

    gcfg = tc.SimConfig(**GRID)
    gstate = tstate.from_numpy(grid, device="cpu")
    loc = tmesh.shard_state(gstate, mesh)
    full = tmesh.gather_state(dp.make_step(gcfg, mesh)(loc), mesh)
    out["step"] = {k: getattr(full, k).numpy() for k in FIELDS}
    diag_state, rows = dp.make_run_diag(gcfg, mesh)(loc, 1, 1)
    again = tdiag.measure(tmesh.gather_state(diag_state, mesh), gcfg)
    out["diag_rows"] = {k: v.numpy() for k, v in rows.items()}
    out["diag_of_gathered"] = {k: float(v) for k, v in again.items()}

    # the axis= hooks against the single set (the whole state on a rank)
    ccfg = gcfg.replace(dt_mode="cfl", dt=1.0)
    rng = np.random.default_rng(3)
    gphi = torch.from_numpy(
        rng.normal(size=(gstate.n, 3)).astype(np.float32))
    sl = slice(mesh.rank * loc.n, (mesh.rank + 1) * loc.n)
    out["hooks"] = dict(
        dt=float(tp.current_dt(loc, ccfg, axis=mesh)),
        dt_single=float(tp.current_dt(gstate, ccfg)),
        com=tmesh.all_gather(tp.com_correct(
            gphi[sl], gstate.mass[sl], gcfg, axis=mesh), mesh).numpy(),
        com_single=tp.com_correct(gphi, gstate.mass, gcfg).numpy())
    if mesh.rank == 0:
        q.put(out)


@pytest.fixture(scope="module")
def starts():
    """The primed start states of both configurations (JAX, numpy)."""
    import jax
    from planetmodel_sph_tpu import config as jc
    from planetmodel_sph_tpu.models import ics, planet as jp
    pcfg = jc.SimConfig(**PROD)
    prod = jax.jit(lambda s: jp.prime(s, pcfg.replace(
        rebuild_every=1, respa_every=1, sort_every=0)))(ics.jupiter(pcfg))
    gcfg = jc.SimConfig(**GRID)
    grid = jax.jit(lambda s: jp.prime(s, gcfg))(ics.jupiter(gcfg))
    return prod, grid


def _np(state):
    return {k: np.asarray(v) for k, v in vars(state).items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["d2", "d4"])
def world(request, starts):
    """(D, the ranks' results, the JAX package's on make_mesh(D))."""
    import jax
    import torch.multiprocessing as mp
    from planetmodel_sph_tpu import config as jc
    from planetmodel_sph_tpu.parallel import dp as jdp, mesh as jmesh
    from planetmodel_sph_tpu.utils import diagnostics as jdiag
    d = request.param
    prod, grid = starts
    q = mp.get_context("spawn").SimpleQueue()
    tmesh.spawn(_rank_checks, d, device="cpu",
                args=(_np(prod), _np(grid), q), timeout_s=300)
    got = q.get()
    m = jmesh.make_mesh(d)
    pcfg, gcfg = jc.SimConfig(**PROD), jc.SimConfig(**GRID)
    run, info = jdp.make_run_info(pcfg, m)(jmesh.shard_state(prod, m), STEPS)
    step = jdp.make_step(gcfg, m)(jmesh.shard_state(grid, m))
    ref = dict(run=_np(jax.device_get(run)),
               info={k: int(v) for k, v in info.items()},
               step=_np(jax.device_get(step)),
               diag={k: float(v)
                     for k, v in jdiag.measure(step, gcfg).items()},
               start=_np(prod))
    return d, got, ref


def test_run_info_matches_jax_dp(world):
    _, got, ref = world
    for k in ("pos", "rho"):
        np.testing.assert_allclose(got["run"][k], ref["run"][k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert got["info"] == ref["info"]
    # the run moved the particles, so the agreement is not vacuous
    assert not np.allclose(got["run"]["pos"], ref["start"]["pos"])


def test_per_step_grid_matches_jax_dp(world):
    _, got, ref = world
    for k in ("pos", "rho", "h"):
        np.testing.assert_allclose(got["step"][k], ref["step"][k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["step"]["n_neighbors"],
                                  ref["step"]["n_neighbors"])


def test_run_diag_rows_are_the_gathered_state(world):
    _, got, ref = world
    rows = got["diag_rows"]
    assert set(rows) == set(ref["diag"]) | {"nbr_overflow", "tree_overflow"}
    for k, v in got["diag_of_gathered"].items():
        assert rows[k].shape == (1,) and float(rows[k][0]) == v, k
    for k in ("total_energy", "kinetic_energy", "potential_energy",
              "radius_rms", "neighbors_avg"):
        np.testing.assert_allclose(float(rows[k][0]), ref["diag"][k],
                                   rtol=1e-4, err_msg=k)
    assert int(rows["nbr_overflow"][0]) == 0 == int(rows["tree_overflow"][0])


def test_axis_hooks_equal_the_single_set(world):
    d, got, _ = world
    hk = got["hooks"]
    assert hk["dt"] == hk["dt_single"] and 0.0 < hk["dt"] < 1.0
    np.testing.assert_array_equal(hk["com"], hk["com_single"])


def test_make_mesh_refuses_more_cards_than_it_sees(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 card"):
        tmesh.make_mesh(4)
    with pytest.raises(ValueError, match="only 1 card"):
        tmesh.spawn(_rank_checks, 2)
    # ranks that share the card take gloo, one rank NCCL
    assert tmesh.placement(4, "cuda:0")[0] == "gloo"
    assert tmesh.placement(1, "cuda:0")[0] == "nccl"
    assert tmesh.placement(1)[0] == "nccl"
    assert tmesh.placement(3, "cpu") == ("gloo", [torch.device("cpu")] * 3)


@pytest.mark.parametrize("call", [
    lambda: tmesh.make_mesh(2),
    lambda: tmesh.spawn(_rank_checks, 2),
    lambda: tmesh.placement(1),
    lambda: cli.main(["run", "--n", "8", "--devices", "2", "--steps", "1"]),
], ids=["make_mesh", "spawn", "placement", "cli_devices"])
def test_dp_entry_points_raise_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_shard_state_needs_a_divisible_n():
    from planetmodel_sph_tpu_torch import config as tc, state as tstate
    st = tstate.zeros(tc.SimConfig(n=10), device="cpu")
    mesh = tmesh.Mesh(None, 1, 3, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="n=10"):
        tmesh.shard_state(st, mesh)
    two = tmesh.Mesh(None, 1, 2, torch.device("cpu"), "gloo")
    assert tmesh.shard_state(st, two).n == 5
