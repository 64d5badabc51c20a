"""The all-pairs kernels' plan (``ops/cuda/pairwise.py``): the Morton order
both sweeps of a force evaluation share, and where it is built.

On the CPU: the permutation is a bijection and the same bits twice, ties
included (equal keys keep their index order); its keys are
``morton.encode`` over the positions' own bounds; ``plan_for`` builds one
only on the card from ``PLAN_MIN_N`` particles on; the kernels' split
loops, with and without a plan, sweep every pair once; the wrappers on CPU
tensors take a plan and run their plain versions. On the card (``gpu``, this file imports no JAX, so it runs
there: ``python3 -m pytest --noconftest -m gpu
tests/test_torch_pairwise_plan.py``): the kernels with a plan against
their plain versions, below and above the size, with a NaN planted in a
far sub-tile, and the card's keys against ``morton.encode``.
"""

import numpy as np
import pytest
import torch

from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import morton
from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw


def _cold_ball(n, seed, device="cpu"):
    """The Jupiter scene's cold ball at n (radius 50, h 2.5 (1 + U[0,
    0.5)), equal masses), drawn with numpy."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1)[:, None]
    pos = u * 50.0 * rng.uniform(size=(n, 1)) ** (1 / 3)
    h = 2.5 * (1 + 0.5 * rng.uniform(size=n))
    f = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(device)
    return f(pos), f(h), f(np.full(n, 100.0 / n))


@pytest.mark.parametrize("n", [1, 63, 1000, 4097])
def test_plan_is_a_bijection_the_same_twice(n):
    pos, _, _ = _cold_ball(n, n)
    plan = pw.plan(pos)
    assert plan.perm.dtype == torch.int64 and plan.perm.shape == (n,)
    assert torch.equal(torch.sort(plan.perm).values, torch.arange(n))
    assert torch.equal(pw.plan(pos).perm, plan.perm)
    assert plan.counts.shape == (2, pw.PLAN_SLOTS)
    assert not plan.counts.any() and pw.near_share(plan) is None


def test_plan_keeps_the_index_order_of_equal_keys():
    """Coincident particles and particles in one Morton cell share a key;
    the stable sort keeps them in index order, and the keys ascend."""
    pos, _, _ = _cold_ball(500, 1)
    pos[100:200] = pos[7]              # a hundred copies of particle 7
    pos[300] = pos[450]
    plan = pw.plan(pos)
    keys = pw.plan_keys_plain(pos)
    k = keys[plan.perm]
    assert bool((k[1:] >= k[:-1]).all())
    ties = k[1:] == k[:-1]
    assert int(ties.sum()) >= 100
    assert bool((plan.perm[1:][ties] > plan.perm[:-1][ties]).all())


def test_plan_keys_are_morton_over_the_positions_own_bounds():
    pos, _, _ = _cold_ball(1000, 2)
    keys = pw.plan_keys_plain(pos)
    lo, hi = pos.amin(dim=0), pos.amax(dim=0)
    assert torch.equal(keys, morton.encode(pos, lo, hi))
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 30


def test_the_plans_constants_are_the_kernels():
    import re
    hdr = _source("common.cuh")
    for name, value in (("PSPH_SUB", pw.SUB),
                        ("PSPH_PLAN_SLOTS", pw.PLAN_SLOTS)):
        m = re.search(rf"#define\s+{name}\s+(\d+)", hdr)
        assert m and int(m.group(1)) == value, name


def test_a_plan_is_built_on_the_card_from_its_size_on(monkeypatch):
    seen = []
    monkeypatch.setattr(pw, "plan", lambda pos: seen.append(pos) or "plan")

    class Card:                     # positions that say they are CUDA
        is_cuda = True

        def __init__(self, n):
            self.shape = (n, 3)
    assert pw.plan_for(Card(pw.PLAN_MIN_N - 1)) is None
    assert pw.plan_for(Card(pw.PLAN_MIN_N)) == "plan"
    assert pw.plan_for(torch.zeros(pw.PLAN_MIN_N, 3)) is None   # CPU
    assert len(seen) == 1


def _source(name):
    import os
    with open(os.path.join(os.path.dirname(pw.__file__), os.pardir,
                           os.pardir, "csrc", name)) as f:
        return f.read()


def _swept(n, planned):
    """[n, n] how often the sweeps' loops take each (target, source) pair,
    and each target's nd, modelled on the kernels' own index arithmetic
    (blocks of 256 targets, splits_for(n) splits; without a plan targets i
    and i + 128, a split's range ceil(n / splits) in tiles of 256; with
    one each warp's targets one box of 64 and split y's sub-tiles y, y +
    splits, ...)."""
    splits = pw.splits_for(n)
    chunk = -(-n // splits)
    nsub = -(-n // pw.SUB)
    count = np.zeros((n, n), np.int32)
    nd = np.zeros(n, np.int64)
    for bx in range(-(-n // 256)):
        lo = bx * 256
        for by in range(splits):
            if planned:
                for w in range(4):
                    wlo = lo + 64 * w
                    if wlo >= n:
                        continue
                    ti = np.array([wlo + 2 * t + u for t in range(32)
                                   for u in range(2) if wlo + 2 * t + u < n])
                    sources = 0
                    for sb in range(by, nsub, splits):
                        base = sb * pw.SUB
                        cnt = min(pw.SUB, n - base)
                        sources += cnt
                        count[np.ix_(ti, np.arange(base, base + cnt))] += 1
                    nd[ti] += sources - ((wlo // pw.SUB) % splits == by)
                continue
            ti = np.array([i for i in (lo + t + 128 * u for t in range(128)
                                       for u in range(2)) if i < n])
            j0 = by * chunk
            j1 = min(n, j0 + chunk)
            for base in range(j0, j1, 256):
                cnt = min(256, j1 - base)
                count[np.ix_(ti, np.arange(base, base + cnt))] += 1
            nd[ti] += max(0, j1 - j0) - ((ti >= j0) & (ti < j1))
    return count, nd


@pytest.mark.parametrize("planned", [False, True], ids=["own", "plan"])
@pytest.mark.parametrize("n", [1, 63, 65, 300, 3000, 4097])
def test_every_pair_is_swept_once_with_and_without_a_plan(n, planned):
    """Both kernels' loops, read from their sources, as _swept models
    them: every (target, source) pair in exactly one block, warp and
    split, each target's nd n - 1."""
    for name in ("pairwise_pass1.cu", "pairwise_pass2.cu"):
        src = _source(name)
        for line in (
                "const int wlo = lo + (threadIdx.x >> 5) * PSPH_SUB;",
                "if (PLAN && wlo >= n) return;",
                "const int j0 = blockIdx.y * chunk;",
                "const int j1 = min(n, j0 + chunk);",
                "for (int base = j0; base < j1; base += PW_TILE) {",
                "const int cnt = min(PW_TILE, j1 - base);",
                "const int nsub = (n + PSPH_SUB - 1) / PSPH_SUB;",
                "const int stride = gridDim.y;",
                "for (int s0 = blockIdx.y; s0 < nsub; s0 += 32 * stride) {",
                "const int sb = s0 + lane * stride;",
                "const bool live = sb < nsub;",
                "const int cnt = min(PSPH_SUB, n - base);"):
            assert line in src, (name, line)
        assert ("PLAN ? wlo + PW_TPT * lane + u : lo + threadIdx.x + u * "
                "PW_THREADS") in src, name
    pw1 = _source("pairwise_pass1.cu")
    assert "const int base = (s0 + b * stride) * PSPH_SUB;" in pw1
    assert "own_split = (wlo / PSPH_SUB) % stride == blockIdx.y;" in pw1
    assert "const bool own = PLAN ? own_split : ti[u] >= j0 && ti[u] < j1;" \
        in pw1
    assert "sources = max(0, j1 - j0);" in pw1
    assert ("const int base = (s0 + (__ffs(todo) - 1) * stride) * PSPH_SUB;"
            in _source("pairwise_pass2.cu"))
    count, nd = _swept(n, planned)
    assert (count == 1).all()
    assert (nd == n - 1).all()


def test_cpu_wrappers_take_a_plan_and_run_plain():
    cfg = tc.jupiter_3k(n=300)
    pos, h, m = _cold_ball(300, 4)
    plan = pw.plan(pos)
    out = pw.pass1(pos, h, m, cfg, plan=plan)
    ref = pw.pass1_plain(pos, h, m, cfg)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    rho = ref.rho
    prs = cfg.eos_k * rho * rho
    assert torch.equal(pw.pass2(pos, h, m, rho, prs, cfg, plan=plan),
                       pw.pass2_plain(pos, h, m, rho, prs, cfg))


def _hold(out, ref):
    """The all-pairs kernels' tolerances (chip_smoke.TOL): counts exact,
    rho and phi rtol 1e-4, vector sums rtol 1e-4 plus 1e-4 of the
    largest magnitude."""
    for o, r in zip(out, ref):
        if not r.is_floating_point():
            assert torch.equal(o, r)
            continue
        torch.testing.assert_close(o, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()),
                                   equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,planned", [(3000, False), (3000, True),
                                       (8000, True)])
def test_kernels_with_a_plan_match_plain_on_the_card(n, planned):
    """The kernels with and without a plan against their plain versions
    on the cold ball; with a NaN mass planted after the plan was built
    (its sub-tile far from most warps), NaN exactly where the plain
    version has it; the card's keys equal morton.encode's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pos, h, m = _cold_ball(n, 11, "cuda")
    plan = pw.plan(pos) if planned else None
    keys = torch.empty(n, dtype=torch.int32, device="cuda")
    counts = torch.ones((2, pw.PLAN_SLOTS), dtype=torch.int32, device="cuda")
    pw.launch("pairwise_plan", [pos, keys, counts, n])
    assert torch.equal(keys, pw.plan_keys_plain(pos))
    assert not counts.any()                  # the keys kernel zeroes them
    cfg = tc.jupiter_3k(n=n, av_alpha=1.0, av_beta=2.0, av_balsara=True)
    out = pw.pass1(pos, h, m, cfg, plan=plan)
    ref = pw.pass1_plain(pos, h, m, cfg)
    _hold(out, ref)
    vel = -0.02 * pos
    prs = cfg.eos_k * ref.rho * ref.rho
    _hold(pw.pass2(pos, h, m, ref.rho, prs, cfg, vel=vel, plan=plan),
          pw.pass2_plain(pos, h, m, ref.rho, prs, cfg, vel=vel))
    if planned:
        assert 0.0 < pw.near_share(plan) < 1.0
    bad = m.clone()
    bad[n // 3] = float("nan")
    out = pw.pass1(pos, h, bad, cfg, plan=plan)
    ref = pw.pass1_plain(pos, h, bad, cfg)
    for o, r in zip(out, ref):
        if r.is_floating_point():
            assert torch.equal(torch.isnan(o), torch.isnan(r))
