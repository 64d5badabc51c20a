"""A copy of the benchmark's directory with two cells more, at a size the
CPU runs in seconds: ``tiny_prod`` (the production configuration on a
PSPH1 snapshot of the settled state's 512 innermost particles, written
into the copy) and ``tiny_dense`` (the dense one at n = 512), with their
references, traffic files and limits, found by name like any other
cell."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil

import torch

from benchmark import registry, traffic

TINY_N = 512
# the tiny production cell's limits (test data: its cell waits outside
# BENCHMARK.json); the tiny dense cell takes dense32k's
TINY_PROD_LIMITS = {
    "start_rho": 1e-3, "start_nn": 8, "start_gradp": 5e-3,
    "start_grav": 0.05, "start_phi": 5e-3, "frame_pos": 0.3,
    "frame_vel": 0.3, "frame_h": 5e-3, "end_rho": 1e-3, "end_nn": 8,
    "end_gradp": 5e-3, "end_grav": 0.05, "end_phi": 5e-3}


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _inner_state(dst: str, cfg) -> dict:
    """The settled state's `cfg.n` innermost particles as a PSPH1 file of
    the configuration `cfg` under `dst`: the traffic's ``inputs``."""
    from planetmodel_sph_tpu_torch.state import zeros
    from planetmodel_sph_tpu_torch.utils import checkpoint
    tr = registry.load_json(os.path.join(registry.HERE, "workloads",
                                         "settled_frames64.json"))
    state, _, step = checkpoint.load(
        os.path.join(registry.ROOT, tr["inputs"]["file"]), device="cpu")
    com = (state.mass[:, None] * state.pos).sum(0) / state.mass.sum()
    r2 = ((state.pos.double() - com.double()) ** 2).sum(1)
    keep = torch.sort(torch.argsort(r2, stable=True)[:cfg.n]).values
    small = zeros(cfg, device="cpu").replace(
        **{k: getattr(state, k)[keep] for k in ("pos", "vel", "mass", "h")})
    rel = os.path.join("tiny", "inner.psph")
    os.makedirs(os.path.join(dst, "tiny"), exist_ok=True)
    checkpoint.save(os.path.join(dst, rel), small, cfg, step)
    return dict(tr["inputs"], file=rel,
                sha256=traffic.sha256(os.path.join(dst, rel)))


def make_tree(dst: str) -> tuple[str, str, dict]:
    """A copy of the benchmark under `dst` with the tiny cells
    ``tiny_prod`` and ``tiny_dense``: (root, benchmark dir, bench dict);
    the root is `dst`."""
    from planetmodel_sph_tpu_torch import config as config_mod
    here = os.path.join(dst, "benchmark")
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = copy.deepcopy(registry.load_json(
        os.path.join(registry.ROOT, "BENCHMARK.json")))
    tiny = {
        "tiny_grid": ("jupiter_100k", {"h_max": 5.0, "n": TINY_N},
                      "settled_frames64",
                      {"frame_steps": 32, "cycle_frames": 1}, None),
        "tiny_ball": ("jupiter_dense", {"n": TINY_N}, "cold_ball_frames10",
                      {"cycle_frames": 2}, "dense32k"),
    }
    cells = {"tiny_grid": "tiny_prod", "tiny_ball": "tiny_dense"}
    for name, (base, set_, traffic_name, extra, like) in tiny.items():
        conf = registry.load_json(os.path.join(here, "configs",
                                               base + ".json"))
        cfg = getattr(config_mod, conf["preset"])(**set_)
        conf.update(name=name, set=set_, config=dataclasses.asdict(cfg))
        path = os.path.join(here, "configs", name + ".json")
        _dump(path, conf)
        shutil.copy(os.path.join(here, "reference", base + ".py"),
                    os.path.join(here, "reference", name + ".py"))
        tr = registry.load_json(os.path.join(here, "workloads",
                                             traffic_name + ".json"))
        if tr["inputs"]["kind"] == "settled_state":
            tr["inputs"] = _inner_state(dst, cfg)
        tr.update(extra, warmup_frames=1, trace_frames=1)
        _dump(os.path.join(here, "workloads", name + ".json"), tr)
        limits = (TINY_PROD_LIMITS if like is None else registry.load_json(
            os.path.join(here, "limits", like + ".json")))
        _dump(os.path.join(here, "limits", cells[name] + ".json"), limits)
        bench["configs"].append(dict(name=name, source="test", file=path,
                                     reduced=[], why="test"))
        bench["workloads"].append(dict(name=cells[name], config=name,
                                       traffic=name, chips=1, why="test"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and like in m["workloads"]:
                m["workloads"].append(cells[name])
    return dst, here, bench
