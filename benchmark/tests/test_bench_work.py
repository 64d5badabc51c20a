"""The kernels' work counts at a tiny size, from the configuration's keys
alone, and the roofline's least time."""

import pytest

from benchmark import registry
from benchmark.roofline import OPS, least_time

GRID = registry.load_json(f"{registry.HERE}/configs/jupiter_100k.json")
DENSE = registry.load_json(f"{registry.HERE}/configs/jupiter_dense.json")
K = registry.kernels()


def test_every_kernel_has_a_pattern_and_a_count():
    assert {"pass1_gradh", "pass2", "gravity_fused", "filter_sph",
            "pairwise_pass1", "pairwise_pass2"} <= set(K)
    for mod in K.values():
        assert isinstance(mod.PATTERN, str) and callable(mod.work)


def test_grid_counts():
    cfg = dict(GRID["config"], n=8)
    n, pairs = 8, 40
    w = {k: m.work(cfg, n, pairs) for k, m in K.items()}
    assert w["pairwise_pass1"] is None and w["pairwise_pass2"] is None
    assert w["p2p"] is None and w["filter_sph"] is None
    sweeps = 1 + (cfg["h_newton_iters"] - 1) / cfg["rebuild_every"]
    assert w["pass1_gradh"][0] == pytest.approx(sweeps * 40 * 26)
    assert w["pass2"][0] == 40 * OPS["pass2"] + 8 * 112 * 32 * OPS["p2p"]
    assert w["gravity_fused"][0] == pytest.approx(8 * 128 * (12 + 28) / 32)


def test_dense_counts():
    cfg = dict(DENSE["config"], n=4)
    w = {k: m.work(cfg, 4, 6) for k, m in K.items()}
    assert w["pass1_gradh"] is None and w["pass2"] is None
    assert w["gravity_fused"] is None
    assert w["pairwise_pass1"][0] == 6 * 38 + 4 * 3 * 38
    assert w["pairwise_pass2"][0] == 6 * 40


def test_least_time_takes_the_larger_bound():
    peaks = {"flops": 1e12, "bytes_per_s": 1e9}
    assert least_time(2e12, 1e9, peaks) == pytest.approx(2.0)
    assert least_time(1e9, 3e9, peaks) == pytest.approx(3.0)
