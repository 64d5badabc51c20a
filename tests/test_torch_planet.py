"""The port's cached production runner against the JAX package's.

The production-stack configuration of tests/test_structure.py (sub-block
windows + true-pair refine + truncation, Newton h, tracked h, quadrupole
far field, fused residual P2P) with grav_com_correction and sort_every=8:
8 steps are two K=4 chunks (two rebuilds, the second reusing the first's
Morton grouping), each two RESPA periods of 2 inner steps. Both packages
start from the same JAX-primed state, handed over as numpy arrays. pos and
rho must agree within rtol 1e-4, atol 1e-4 (the bound test_structure.py
holds the fused cached run to), the overflow counters exactly.
"""

import jax
import numpy as np
import pytest

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics
from planetmodel_sph_tpu.models import planet as jp
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.models import planet as tp
from planetmodel_sph_tpu_torch.ops.cuda import groups2 as tk
from planetmodel_sph_tpu_torch.utils import diagnostics as tdiag
from planetmodel_sph_tpu.utils import diagnostics as jdiag

KW = dict(n=1024, radius=30.0, particle_radius=3.0, neighbor_mode="grid",
          gravity_solver="tree", grad_p_mode="grad_h", h_mode="newton",
          h_track_margin=0.04, sph_refine_subblock=True,
          sph_refined_window=64, rebuild_every=4, respa_every=2,
          sort_every=8, multipole_order=2, grav_com_correction=True,
          nbr_group_size=32, nbr_sub=16, nbr_group_level=2, nbr_window=128,
          p2p_window=128, m2p_window=128, fuse_p2p_sph=True,
          fuse_p2p_residual=True)
JCFG = jc.SimConfig(**KW)
TCFG = tc.SimConfig(**KW)
STEPS = 8


@pytest.fixture(scope="module")
def runs():
    prime_cfg = JCFG.replace(rebuild_every=1, respa_every=1)
    st0 = jax.jit(lambda s: jp.prime(s, prime_cfg))(ics.jupiter(JCFG))
    arrays = {k: np.asarray(v) for k, v in vars(st0).items()}
    ref, info_ref = jp.run_info(st0, JCFG, STEPS)
    jax.block_until_ready(ref)
    tk.reset_launches()
    start = tstate.from_numpy(arrays, device="cpu")
    out, info = tp.run_info(start, TCFG, STEPS)
    return ref, info_ref, out, info, start


def test_run_info_matches_jax(runs):
    ref, info_ref, out, info, _ = runs
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(ref.pos),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.rho.numpy(), np.asarray(ref.rho),
                               rtol=1e-4, atol=1e-4)
    assert {k: int(v) for k, v in info.items()} == \
        {k: int(v) for k, v in info_ref.items()}
    # the run moved the particles, so the agreement is not vacuous
    assert not np.allclose(out.pos.numpy(), runs[4].pos.numpy())


def test_run_info_fields_match_jax(runs):
    ref, _, out, _, _ = runs
    np.testing.assert_allclose(out.vel.numpy(), np.asarray(ref.vel),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out.h.numpy(), np.asarray(ref.h), rtol=1e-4)
    for name in ("n_neighbors", "n_direct", "n_approx"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        # counts sit on q = 2 and MAC edges: a particle moved by rounding
        # may cross one, so a handful may differ, never many
        assert (a != b).mean() < 0.01, name
    for k in vars(out):
        assert getattr(out, k).shape == tuple(np.shape(getattr(ref, k))), k


def test_diagnostics_match_jax(runs):
    ref, _, out, _, _ = runs
    d_ref = jdiag.measure(ref, JCFG)
    d_out = tdiag.measure(out, TCFG)
    for key in ("mass", "kinetic_energy", "potential_energy",
                "internal_energy", "total_energy", "inertia_com",
                "radius_rms"):
        np.testing.assert_allclose(float(d_out[key]), float(d_ref[key]),
                                   rtol=1e-4, err_msg=key)
    assert set(d_out) == set(d_ref)


def test_cpu_run_launches_no_kernel(runs):
    assert all(v == 0 for v in tk.LAUNCHES.values())


def test_runner_refuses_uncached_step():
    """The uncached step itself is ported (tests/test_torch_step.py), and
    so are cached chunks with relax-mode h (tests/test_torch_grid_step.py),
    the cached dense step and unsorted chunks
    (tests/test_torch_cached_carry.py), and so are any grid batching and
    the bfloat16 pair path (tests/test_torch_bf16_gravity.py); what the
    runner still refuses, by name and before any work, are values of
    those knobs that mean nothing."""
    with pytest.raises(ValueError, match="kernel_gb"):
        tp.run_info(None, tc.jupiter_3k(n=64, rebuild_every=4,
                                        gravity_solver="tree",
                                        kernel_gb=0), 4)
    with pytest.raises(ValueError, match="grav_pair_dtype"):
        tp.run_info(None, TCFG.replace(sorted_chunks=False,
                                       grav_pair_dtype="float16"), 4)


def test_unsorted_chunks_repeat_the_sorted_run(runs):
    """The order the particles run in (a sorted chunk's padded layout, or
    the state's own order) does not change the dynamics: with the centre-
    of-mass correction's sums in float64 the unsorted run repeats the
    sorted one bit for bit."""
    import torch
    start = runs[4]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        srt, _ = tp.run_info(start, TCFG, STEPS)
        uns, _ = tp.run_info(start, TCFG.replace(sorted_chunks=False), STEPS)
    finally:
        torch.set_num_threads(n)
    for k in ("pos", "vel", "accel", "h", "rho", "n_neighbors", "n_direct",
              "n_approx"):
        assert torch.equal(getattr(uns, k), getattr(srt, k)), k
