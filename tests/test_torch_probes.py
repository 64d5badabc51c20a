"""The tools' four probes (``ops/cuda/probes.py``): each plain version
against the JAX side on the same numpy inputs.

- ``probe_fma`` against ``tools/roofline.py``'s ``_vpu_kernel`` run through
  ``pl.pallas_call(..., interpret=True)`` at [8, 128], reps = 4 (rtol 1e-5);
- ``probe_launch``, ``probe_gather`` and ``probe_pass1_tile`` against their
  functions written in jnp: the reference's trivial kernel, gather kernel
  and tile kernel are closures inside ``measure_launch``, ``bench_gathers``
  and ``bench_kernel_tiles`` that no test can import, so the test computes
  their function from the module-level pieces (the tile sweep from
  ``tools/microbench.py``'s ``_spline_w``, masked and summed chunk by chunk
  as the closure does). Launch and gather exactly, the tile sweep to
  1e-5 of each target's sum of |m W| (random-normal terms cancel).

``tools/*.py`` are imported from their files and not edited. Each wrapper
also raises for a CUDA-typed request where the kernels cannot be built.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from planetmodel_sph_tpu_torch.ops.cuda import build, launch, probes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


roof = _tool("roofline")
micro = _tool("microbench")


def test_probe_fma_matches_the_pallas_vpu_kernel():
    rng = np.random.default_rng(0)
    x = (1.0000001 * (1.0 - 0.5 * rng.uniform(size=(8, 128)))).astype(
        np.float32)
    reps = 4
    spec = pl.BlockSpec((8, 128), lambda g: (0, 0))
    ref = pl.pallas_call(
        functools.partial(roof._vpu_kernel, reps=reps), grid=(1,),
        in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(jnp.asarray(x))
    out = probes.probe_fma(torch.from_numpy(x), reps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
    assert float(out.max()) > 2.0          # the chain did run


def test_probe_fma_tolerance_covers_single_rounding():
    """The kernel fuses each multiply-add (one rounding), the plain version
    rounds twice: emulated in float64 at the chip check's shape and reps,
    the two stay within chip_smoke's FMA_RTOL = 1e-4."""
    rng = np.random.default_rng(1)
    v = (1.0000001 * (1.0 - 0.5 * rng.uniform(size=4096))).astype(
        np.float32)
    fused = v.copy()
    for _ in range(4 * 512):
        fused = (fused.astype(np.float64) * v + v).astype(np.float32)
    plain = probes.probe_fma_plain(torch.from_numpy(v), 512).numpy()
    np.testing.assert_allclose(plain, fused, rtol=1e-4)


def test_probe_launch_matches_the_trivial_kernel():
    x = np.random.default_rng(2).normal(size=(8, 128)).astype(np.float32)
    ref = jnp.asarray(x) * 1.000001          # trivial_kernel's body
    out = probes.probe_launch(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_probe_gather_matches_the_row_gather():
    rng = np.random.default_rng(3)
    nb, bsz, c, g, w = 37, 64, 7, 11, 5
    packed = rng.normal(size=(nb, bsz * c)).astype(np.float32)
    idx = rng.integers(0, nb, (g, w)).astype(np.int32)
    ref = jnp.asarray(packed)[jnp.asarray(idx)]   # gather_kernel per (g, w)
    out = probes.probe_gather(torch.from_numpy(packed),
                              torch.from_numpy(idx))
    assert out.shape == (g, w, bsz * c)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_probe_gather_clamps_ids_as_the_window_gather():
    packed = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[-1, 0, 3, 9]], dtype=torch.int32)
    out = probes.probe_gather(packed, idx)
    np.testing.assert_array_equal(out[0, :, 0].numpy(), [0.0, 0.0, 9.0, 9.0])


def _tile_reference(nv, tgt, rows, tb, chunk):
    """bench_kernel_tiles' kern in jnp: per instance, trips chunks of the
    window, slots below nv with live > 0.5, m * _spline_w summed."""
    tx, ty, tz, tih = (jnp.asarray(t) for t in tgt)
    sx, sy, sz, sm, slv = (jnp.asarray(r) for r in rows)
    gb, s = sx.shape
    out = []
    for gi in range(gb):
        sl = slice(gi * tb, (gi + 1) * tb)
        acc = jnp.zeros((tb, 1), jnp.float32)
        trips = min(-(-int(nv[gi]) // chunk), s // chunk)
        iota = jnp.arange(chunk)[None, :]
        for ci in range(trips):
            off = ci * chunk
            cut = lambda r: r[gi, off:off + chunk][None, :]
            dxx = tx[sl] - cut(sx)
            dxy = ty[sl] - cut(sy)
            dxz = tz[sl] - cut(sz)
            r2 = dxx * dxx + dxy * dxy + dxz * dxz
            pair = ((iota + off) < int(nv[gi])) & (cut(slv) > 0.5)
            m_eff = jnp.where(pair, cut(sm), 0.0)
            acc = acc + jnp.sum(m_eff * micro._spline_w(r2, tih[sl]),
                                axis=1, keepdims=True)
        out.append(acc)
    return np.asarray(jnp.concatenate(out))


@pytest.mark.parametrize("sg", [1, 2])
def test_probe_pass1_tile_matches_the_reference_sweep(sg):
    rng = np.random.default_rng(10 + sg)
    bsz, chunk, w = 64, 512, 16
    gb, tb, s = 6 // sg, 64 * sg, w * bsz
    # random normals as the tool draws them (negative ih and m included);
    # nv below one chunk, across chunks, and past the window
    nv = np.array([100, 700, 1023, 1024, 1500, 640][:gb], np.int32)
    tgt = [rng.normal(size=(gb * tb, 1)).astype(np.float32)
           for _ in range(4)]
    rows = [rng.normal(size=(gb, s)).astype(np.float32) for _ in range(5)]
    ref = _tile_reference(nv, tgt, rows, tb, chunk)
    t = lambda a: torch.from_numpy(a)
    out = probes.probe_pass1_tile(t(nv), [t(a) for a in tgt],
                                  [t(a) for a in rows], tb=tb, chunk=chunk)
    rho, mag = probes.probe_pass1_tile_plain(
        t(nv), [t(a) for a in tgt], [t(a) for a in rows], chunk=chunk)
    assert torch.equal(out, rho)
    assert (ref < 0).any()                   # signed terms
    err = np.abs(out.numpy().astype(np.float64) - ref)
    assert (err <= 1e-5 * mag.numpy()).all(), float(err.max())


def test_tile_extent_is_the_reference_loop_bound():
    nv = torch.tensor([0, 1, 511, 512, 513, 2240, 6144, 9000],
                      dtype=torch.int32)
    ext = probes.tile_extent(nv, 6144, 512)
    trips = [min(-(-int(n) // 512), 12) for n in nv]
    assert ext.tolist() == [min(int(n), t * 512) for n, t in zip(nv, trips)]


def _cpu_calls():
    f = torch.ones((8, 128))
    i = torch.zeros((2, 3), dtype=torch.int32)
    nv = torch.ones(1, dtype=torch.int32)
    col = [torch.zeros((64, 1)) for _ in range(4)]
    row = [torch.zeros((1, 512)) for _ in range(5)]
    return {"probe_fma": lambda: probes.probe_fma(f, 2),
            "probe_launch": lambda: probes.probe_launch(f),
            "probe_gather": lambda: probes.probe_gather(f, i),
            "probe_pass1_tile": lambda: probes.probe_pass1_tile(
                nv, col, row, tb=64)}


@pytest.mark.parametrize("name", probes.KERNELS)
def test_probe_wrapper_raises_for_a_cuda_request_without_a_card(
        name, monkeypatch, tmp_path):
    """A request the wrapper takes for a CUDA one launches or raises: here
    the kernel cannot be built (no nvcc), so it raises, and it neither
    falls back to the plain version nor counts a launch."""
    monkeypatch.setattr(probes, "is_cuda", lambda *_: True)
    monkeypatch.setattr(build, "BUILD", str(tmp_path))
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    launch.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        _cpu_calls()[name]()
    assert launch.LAUNCHES[name] == 0


def test_probe_wrappers_run_plain_on_the_cpu_and_count_nothing():
    launch.reset_launches()
    for call in _cpu_calls().values():
        call()
    assert all(v == 0 for v in launch.LAUNCHES.values())


def test_probe_wrappers_refuse_bad_arguments():
    with pytest.raises(TypeError):
        probes.probe_gather(torch.ones((4, 3)), torch.zeros((2, 2)))
    with pytest.raises(ValueError):
        probes.probe_launch(torch.ones((2, 1024)))
    with pytest.raises(ValueError):
        probes.probe_pass1_tile(torch.ones(1, dtype=torch.int32),
                                [torch.zeros((64, 1))] * 4,
                                [torch.zeros((1, 512))] * 5, tb=32)
