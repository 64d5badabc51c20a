"""The benchmark's own PSPH1 reader against the program's checkpoint
loader, and the settled state's inputs."""

import os

import numpy as np
import torch

from benchmark import psph, registry, traffic

STATE = os.path.join(registry.ROOT, "docs", "results", "drift100k_r5ship",
                     "state.psph")


def test_reader_matches_the_programs_loader():
    from planetmodel_sph_tpu_torch.utils import checkpoint
    header, arrays = psph.read(STATE)
    state, cfg, step = checkpoint.load(STATE, device="cpu")
    assert step == header["step"] == 12000
    assert cfg.n == header["config"]["n"]
    for name, a in arrays.items():
        assert np.array_equal(a, getattr(state, name).numpy()), name


def test_rotation_is_orthonormal_and_seeded():
    r = traffic.rotation(2**31 + 12345)
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-12)
    assert np.isclose(np.linalg.det(r), 1.0)
    assert np.array_equal(r, traffic.rotation(2**31 + 12345))
    assert not np.allclose(r, traffic.rotation(2**31 + 12346))


def test_settled_inputs_keep_the_distances(tiny):
    cell = tiny("tiny_prod")
    cfg = cell.config["config"]
    a = traffic.make_inputs(cell.traffic, cfg, 5, "cpu", cell.root)
    b = traffic.make_inputs(cell.traffic, cfg, 6, "cpu", cell.root)
    da = torch.cdist(a["pos"].double(), a["pos"].double())
    db = torch.cdist(b["pos"].double(), b["pos"].double())
    assert torch.allclose(da, db, atol=1e-4)
    assert not torch.allclose(a["pos"], b["pos"])
    assert torch.equal(a["h"], b["h"]) and torch.equal(a["mass"], b["mass"])


def test_cold_ball_is_seeded(tiny):
    cell = tiny("tiny_dense")
    cfg = cell.config["config"]
    a = traffic.make_inputs(cell.traffic, cfg, 2**32 + 1, "cpu", cell.root)
    b = traffic.make_inputs(cell.traffic, cfg, 2**32 + 1, "cpu", cell.root)
    assert all(torch.equal(a[k], b[k]) for k in a)
    r = torch.sqrt((a["pos"] ** 2).sum(dim=-1))
    assert float(r.max()) < cfg["radius"] and a["pos"].shape[0] == 512
