"""The port's halo layout (``parallel/halo.py``, ``mesh.ppermute``) on gloo
ranks on the CPU against the JAX package's on its virtual CPU mesh.

One module-scoped spawn of D = 4 ranks runs every rank-side check of this
file once; rank 0 hands the gathered results to this process, which holds
them against ``planetmodel_sph_tpu.parallel.halo`` on ``make_mesh(4)`` from
the same numpy states (built once with the JAX package's ICs):

- on a chain of four touching clusters along x (the recipe of
  tests/test_halo.py, whose Morton order is the chain order, so ring R = 1
  covers every raw neighbour): ``make_prime``, ``make_step``, ``make_run``
  (4 steps of the cached production stack) and ``make_run_diag``, pos and
  rho within rtol 1e-4 / atol 1e-4 (the port's multi-step bound), the
  overflow and ``halo_violations`` counts exactly;
- the single-ball violation cases of tests/test_halo.py at D = 4 (the
  Morton quadrants meet at the core, which no ring of 1 covers): the
  counts equal the JAX package's, and above 0;
- ``run_resharded`` from a scrambled chain: one re-shard in both;
- ``mesh.ppermute`` and ``halo._ring_collect``: the rank order and the
  zero fill of ``jax.lax.ppermute``.

Beside them: ``bytes_per_step`` equal to the reference's, the refusal of
2R >= D (D = 1, 2, 4 at R = 2) and the reference's duplicated sources at
D = 2, R = 1 that the refusal exists for, and the CLI's halo run.
"""

import json

import numpy as np
import pytest
import torch

from planetmodel_sph_tpu_torch import cli
from planetmodel_sph_tpu_torch.parallel import halo, mesh as tmesh

D = 4
CHAIN = dict(n=1024, radius=12.0, particle_radius=2.5, block_n=128,
             gravity_solver="tree", neighbor_mode="grid", nbr_group_size=64,
             nbr_group_level=4, nbr_window=192, p2p_window=256,
             m2p_window=256, dp_mode="halo", halo_ring_radius=1,
             halo_chunk=64)
# the cached production stack of tests/test_halo.py:134-137
PROD = dict(rebuild_every=4, sort_every=8, respa_every=2,
            grad_p_mode="grad_h", h_mode="newton", h_track_margin=0.04,
            sph_refine_subblock=True, sph_refined_window=96,
            multipole_order=2)
RUN_STEPS = 4
# the single-ball cases of tests/test_halo.py:114-176: two balls (the
# per-step case runs on the cached case's ball, n = 1024 where the
# reference's per-step case takes 2048) and (ball, config, steps) a case
BALL_STATES = {
    "tiny": dict(n=512, radius=24.0, nbr_group_level=2, nbr_window=192,
                 p2p_window=256, m2p_window=256),
    "ball": dict(n=1024, radius=30.0, nbr_group_level=3, nbr_window=256,
                 p2p_window=320, m2p_window=320),
}
BALLS = {
    "per_step": ("ball", {}, 1),
    "cached_tiny": ("tiny", dict(rebuild_every=2), 2),
    "cached": ("ball", dict(rebuild_every=2), 2),
}
PERMS = {
    "ring+1": [(i, (i + 1) % D) for i in range(D)],
    # ranks 0 and 1 receive nothing: zeros
    "partial": [(0, 2), (1, 3)],
}


def _ball_cfg(ball, kw=None):
    return {**CHAIN, **BALL_STATES[ball], **(kw or {})}


def _gathered(state, mesh):
    full = tmesh.gather_state(state, mesh)
    return {k: getattr(full, k).numpy() for k in vars(full)}


def _rank_checks(mesh, chain, balls, scrambled, path):
    """Every rank: the halo runs of this file on its shard; rank 0 saves
    the gathered results to `path` (a queue's pipe would fill before the
    parent reads it)."""
    from planetmodel_sph_tpu_torch import config as tc, state as tstate
    out = {}
    cfg = tc.SimConfig(**CHAIN)
    loc = tmesh.shard_state(tstate.from_numpy(chain, device="cpu"), mesh)
    hal = halo.morton_shard_state(loc, mesh)
    out["sharded"] = _gathered(hal, mesh)
    out["prime"] = _gathered(halo.make_prime(cfg, mesh)(hal), mesh)
    out["step"] = _gathered(halo.make_step(cfg, mesh)(hal), mesh)
    run, info = halo.make_run(cfg.replace(**PROD), mesh)(hal, RUN_STEPS)
    out["run"] = _gathered(run, mesh)
    out["run_info"] = {k: int(v) for k, v in info.items()}
    _, rows = halo.make_run_diag(cfg, mesh)(hal, 2, 1)
    out["diag"] = {k: v.numpy() for k, v in rows.items()}

    out["balls"] = {}
    for name, (ball, kw, steps) in BALLS.items():
        bcfg = tc.SimConfig(**_ball_cfg(ball, kw))
        b = tmesh.shard_state(tstate.from_numpy(balls[ball], device="cpu"),
                              mesh)
        _, binfo = halo.make_run(bcfg, mesh)(
            halo.morton_shard_state(b, mesh), steps)
        out["balls"][name] = {k: int(v) for k, v in binfo.items()}

    rcfg = cfg.replace(rebuild_every=2)
    bad = tmesh.shard_state(tstate.from_numpy(scrambled, device="cpu"),
                            mesh)
    msgs = []
    res, total, reshards = halo.run_resharded(bad, rcfg, mesh, 8, span=4,
                                              log=msgs.append)
    out["reshard"] = dict(total=total, reshards=reshards, msgs=msgs,
                          finite=bool(torch.isfinite(
                              tmesh.gather_state(res, mesh).pos).all()))

    x = (torch.arange(6, dtype=torch.float32).reshape(3, 2)
         + 100.0 * mesh.rank)
    out["ppermute"] = {
        name: tmesh.all_gather(tmesh.ppermute(x, mesh, perm), mesh).numpy()
        for name, perm in PERMS.items()}
    out["ring_collect"] = tmesh.all_gather(
        halo._ring_collect(x, mesh, 1), mesh).numpy()
    out["sizes"] = (tmesh.axis_size(mesh), tmesh.axis_index(mesh))
    if mesh.rank == 0:
        torch.save(out, path)


def _np(state):
    return {k: np.asarray(v) for k, v in vars(state).items()}


def _chain_state(jcfg, n_clusters=D, spacing=30.0):
    """tests/test_halo.py's chain: n_clusters balls along x."""
    import jax
    import jax.numpy as jnp
    from planetmodel_sph_tpu.models import ics
    nc = jcfg.n // n_clusters
    parts = []
    for k in range(n_clusters):
        sub = jcfg.replace(n=nc, total_mass=jcfg.total_mass / n_clusters,
                           seed=k)
        st = ics.jupiter(sub)
        off = jnp.array([k * spacing, 0.0, 0.0], st.pos.dtype)
        parts.append(st.replace(pos=st.pos + off))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the ranks' results, the JAX package's on make_mesh(4))."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from planetmodel_sph_tpu import config as jc
    from planetmodel_sph_tpu.models import ics, planet as jp
    from planetmodel_sph_tpu.parallel import halo as jhalo
    from planetmodel_sph_tpu.parallel import mesh as jmesh
    cfg = jc.SimConfig(**CHAIN)
    chain = jax.jit(lambda s: jp.prime(s, cfg))(_chain_state(cfg))
    balls = {}
    for ball in BALL_STATES:
        bcfg = jc.SimConfig(**_ball_cfg(ball))
        balls[ball] = _np(jax.jit(lambda s, c=bcfg: jp.prime(s, c))(
            ics.jupiter(bcfg)))
    rcfg = cfg.replace(rebuild_every=2)
    rstate = jax.jit(lambda s: jp.prime(s, rcfg.replace(rebuild_every=1)))(
        _chain_state(rcfg))
    perm = np.random.default_rng(7).permutation(cfg.n)
    scrambled = {k: v[perm] for k, v in _np(rstate).items()}

    path = str(tmp_path_factory.mktemp("halo") / "ranks.pt")
    tmesh.spawn(_rank_checks, D, device="cpu",
                args=(_np(chain), balls, scrambled, path), timeout_s=300)
    got = torch.load(path, weights_only=False)

    m = jmesh.make_mesh(D)
    sharded = jhalo.morton_shard_state(chain, m)
    get = lambda s: _np(jax.device_get(s))
    run, info = jhalo.make_run(cfg.replace(**PROD), m)(sharded, RUN_STEPS)
    _, rows = jhalo.make_run_diag(cfg, m)(sharded, 2, 1)
    ref = dict(sharded=get(sharded),
               prime=get(jhalo.make_prime(cfg, m)(sharded)),
               step=get(jhalo.make_step(cfg, m)(sharded)),
               run=get(run), run_info={k: int(v) for k, v in info.items()},
               diag={k: np.asarray(v) for k, v in rows.items()},
               start=_np(chain))
    ref["balls"] = {}
    for name, (ball, kw, steps) in BALLS.items():
        bcfg = jc.SimConfig(**_ball_cfg(ball, kw))
        b = jhalo.morton_shard_state(_as_jax_state(balls[ball]), m)
        _, binfo = jhalo.make_run(bcfg, m)(b, steps)
        ref["balls"][name] = {k: int(v) for k, v in binfo.items()}
    bad = jmesh.shard_state(_as_jax_state(scrambled), m)
    msgs = []
    res, total, reshards = jhalo.run_resharded(bad, rcfg, m, 8, span=4,
                                               log=msgs.append)
    ref["reshard"] = dict(total=total, reshards=reshards, msgs=msgs)

    x = np.concatenate([np.arange(6, dtype=np.float32).reshape(3, 2)
                        + 100.0 * r for r in range(D)])
    pp = lambda perm: jax.jit(shard_map(
        lambda v: jax.lax.ppermute(v, "dp", perm), mesh=m,
        in_specs=P("dp"), out_specs=P("dp")))(x)
    ref["ppermute"] = {name: np.asarray(pp(perm))
                       for name, perm in PERMS.items()}
    ref["ring_collect"] = np.asarray(jax.jit(shard_map(
        lambda v: jhalo._ring_collect(v, "dp", 1), mesh=m,
        in_specs=P("dp"), out_specs=P("dp")))(x))
    return got, ref


def _as_jax_state(arrays):
    from planetmodel_sph_tpu import state as jstate
    import jax.numpy as jnp
    return jstate.ParticleState(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()})


def _close(got, ref, keys=("pos", "rho")):
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_morton_shard_state_matches_jax(world):
    got, ref = world
    for k, v in ref["sharded"].items():
        np.testing.assert_array_equal(got["sharded"][k], v, err_msg=k)


def test_halo_prime_matches_jax(world):
    got, ref = world
    g, r = got["prime"], ref["prime"]
    _close(g, r, ("rho", "phi"))
    scale = np.abs(r["grad_phi"]).max()
    np.testing.assert_allclose(g["grad_phi"], r["grad_phi"], rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_array_equal(g["n_neighbors"], r["n_neighbors"])
    np.testing.assert_array_equal(g["n_approx"], r["n_approx"])


def test_halo_step_matches_jax(world):
    got, ref = world
    _close(got["step"], ref["step"], ("pos", "rho", "h"))
    np.testing.assert_array_equal(got["step"]["n_neighbors"],
                                  ref["step"]["n_neighbors"])


def test_halo_cached_run_matches_jax(world):
    got, ref = world
    _close(got["run"], ref["run"])
    assert got["run_info"] == ref["run_info"]
    assert set(got["run_info"]) == {"nbr_overflow", "tree_overflow",
                                    "halo_violations"}
    # the chain is ring-coherent: nothing counted, nothing dropped
    assert not any(got["run_info"].values())
    # the run moved the particles, so the agreement is not vacuous
    assert not np.allclose(got["run"]["pos"], ref["sharded"]["pos"])


def test_halo_run_diag_rows_match_jax(world):
    got, ref = world
    rows, jrows = got["diag"], ref["diag"]
    assert set(rows) == set(jrows)
    for k in ("nbr_overflow", "tree_overflow", "halo_violations"):
        np.testing.assert_array_equal(rows[k], jrows[k], err_msg=k)
    for k in ("total_energy", "kinetic_energy", "potential_energy",
              "radius_rms", "neighbors_avg"):
        np.testing.assert_allclose(rows[k], jrows[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(BALLS))
def test_single_ball_violations_counted_as_jax(world, name):
    got, ref = world
    assert got["balls"][name] == ref["balls"][name]
    assert got["balls"][name]["halo_violations"] > 0


def test_run_resharded_reshards_once_as_jax(world):
    got, ref = world
    assert got["reshard"]["reshards"] == ref["reshard"]["reshards"] == 1, \
        got["reshard"]["msgs"]
    assert got["reshard"]["total"] == {k: int(v) for k, v in
                                       ref["reshard"]["total"].items()}
    assert got["reshard"]["total"]["halo_violations"] == 0
    assert got["reshard"]["finite"]


def test_ppermute_and_ring_collect_match_jax_lax(world):
    got, ref = world
    assert got["sizes"] == (D, 0)
    for name in PERMS:
        np.testing.assert_array_equal(got["ppermute"][name],
                                      ref["ppermute"][name], err_msg=name)
    # ranks 0 and 1 receive nothing under "partial": zeros
    assert not got["ppermute"]["partial"][:6].any()
    np.testing.assert_array_equal(got["ring_collect"], ref["ring_collect"])


@pytest.mark.parametrize("n,d,r", [
    (8192, 8, 3), (8192, 8, 1), (65536, 64, 3), (32768, 8, 3),
    (4096, 4, 1), (1024, 16, 2), (2048, 2, 1),
])
@pytest.mark.parametrize("chunk", [16, 64])
def test_bytes_per_step_equals_the_reference(n, d, r, chunk):
    from planetmodel_sph_tpu import config as jc
    from planetmodel_sph_tpu.parallel import halo as jhalo
    from planetmodel_sph_tpu_torch import config as tc
    kw = dict(halo_ring_radius=r, halo_chunk=chunk)
    assert halo.bytes_per_step(tc.SimConfig(**kw), n, d) == \
        jhalo.bytes_per_step(jc.SimConfig(**kw), n, d)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_ring_reaching_a_shard_twice_is_refused(d):
    from planetmodel_sph_tpu_torch import config as tc
    cfg = tc.SimConfig(**{**CHAIN, "halo_ring_radius": 2})
    with pytest.raises(ValueError, match=r"halo_ring_radius=2 .*2R >= D"):
        halo.check_config(cfg, d)
    fake = tmesh.Mesh(None, 0, d, torch.device("cpu"), "gloo")
    for make in (halo.make_step, halo.make_prime, halo.make_run,
                 halo.make_run_diag):
        with pytest.raises(ValueError, match="2R >= D"):
            make(cfg, fake)
    with pytest.raises(ValueError, match="2R >= D"):
        halo.run_resharded(None, cfg, fake, 4)
    # 2R < D passes
    halo.check_config(cfg, 5)


def test_halo_config_refusals_by_name():
    from planetmodel_sph_tpu_torch import config as tc
    with pytest.raises(ValueError, match="neighbor_mode='grid'"):
        halo.check_config(tc.SimConfig(**{**CHAIN,
                                          "neighbor_mode": "dense"}), 4)
    with pytest.raises(ValueError, match="direct"):
        halo.check_config(tc.SimConfig(**{**CHAIN,
                                          "gravity_solver": "direct"}), 4)
    with pytest.raises(ValueError, match=">= 1"):
        halo.check_config(tc.SimConfig(**{**CHAIN,
                                          "halo_ring_radius": 0}), 4)


def test_reference_duplicates_sources_at_two_ranks():
    """What the refusal exists for: the reference's ring at D = 2, R = 1
    collects the other shard twice (+1 and -1), so its halo prime counts
    more neighbours than the replicated prime of the same Morton-sharded
    state, though the ring covers every shard there."""
    import jax
    from planetmodel_sph_tpu import config as jc
    from planetmodel_sph_tpu.models import ics
    from planetmodel_sph_tpu.parallel import dp as jdp, halo as jhalo
    from planetmodel_sph_tpu.parallel import mesh as jmesh
    cfg = jc.SimConfig(**{**CHAIN, "n": 512, "gravity_solver": "none",
                          "radius": 24.0, "particle_radius": 3.0,
                          "nbr_group_size": 32, "nbr_group_level": 2,
                          "nbr_window": 128, "p2p_window": 128,
                          "m2p_window": 128})
    m = jmesh.make_mesh(2)
    st = jhalo.morton_shard_state(ics.jupiter(cfg), m)
    nn_h = np.asarray(jax.device_get(
        jhalo.make_prime(cfg, m)(st).n_neighbors))
    nn_r = np.asarray(jax.device_get(
        jdp.make_prime(cfg.replace(dp_mode="replicated"), m)(st)
        .n_neighbors))
    assert nn_h.sum() > nn_r.sum() and (nn_h >= nn_r).all()
    from planetmodel_sph_tpu_torch import config as tc
    with pytest.raises(ValueError, match="2R >= D"):
        halo.check_config(tc.SimConfig(**{**CHAIN, "n": 512}), 2)


def test_cli_runs_the_halo_layout(tmp_path, capfd):
    """``cli run --device cpu --devices 4 --set dp_mode=halo``: four gloo
    ranks, the Morton-range shards primed and run by the halo runner,
    rank 0's rows with halo_violations beside the overflow counters."""
    metrics = str(tmp_path / "m.jsonl")
    assert cli.main([
        "run", "--device", "cpu", "--n", "512", "--neighbor", "grid",
        "--gravity", "tree", "--devices", "4", "--steps", "2",
        "--diag-every", "1", "--metrics-jsonl", metrics,
        "--set", "dp_mode=halo", "--set", "halo_chunk=16",
        "--set", "nbr_group_size=32", "--set", "nbr_group_level=2",
        "--set", "nbr_window=128", "--set", "p2p_window=128",
        "--set", "m2p_window=128"]) == 0
    err = capfd.readouterr().err
    assert "2 steps in" in err and "(dp x4)" in err
    assert "energy drift:" in err
    rows = [json.loads(ln) for ln in open(metrics)]
    assert [r["step"] for r in rows] == [1, 2]
    assert all("halo_violations" in r for r in rows)
    assert all(np.isfinite(r["total_energy"]) for r in rows)
