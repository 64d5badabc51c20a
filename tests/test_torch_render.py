"""The port's renderer (``planetmodel_sph_tpu_torch/utils/render.py``) and
the equilibrium tool's radial profile against the JAX package's, on the
same arrays: the same profile rows; a PNG written by each for every colour
mode, the quiver and the block overlay, whose boxes are those of the
reference structure's groups; the GIF of a frame directory."""

import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu import state as jstate
from planetmodel_sph_tpu.ops import structure as jstructure
from planetmodel_sph_tpu.utils import render as jrender
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.models import ics as tics
from planetmodel_sph_tpu_torch.models import planet as tp
from planetmodel_sph_tpu_torch.state import FIELDS, from_numpy
from planetmodel_sph_tpu_torch.utils import render as trender

KW = dict(n=512, radius=20.0, particle_radius=4.0, neighbor_mode="grid",
          gravity_solver="tree", nbr_group_size=32, nbr_group_level=2,
          sph_refine_subblock=True, sph_refined_window=64)
TCFG = tc.SimConfig(**KW)
JCFG = jc.SimConfig(**KW)

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def arrays():
    """A primed grid + tree state, two materials, as numpy arrays."""
    st = tp.prime(tics.jupiter(TCFG, device="cpu"), TCFG)
    out = {k: getattr(st, k).numpy() for k in FIELDS}
    out["matid"] = (np.arange(TCFG.n) % 2).astype(np.int32)
    # a rotation about z, so the quiver has arrows to draw
    out["vel"] = np.stack([-out["pos"][:, 1], out["pos"][:, 0],
                           np.zeros(TCFG.n, np.float32)], axis=1) * 0.05
    return out


def _jax_state(arrays):
    return jstate.ParticleState(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()})


def test_radial_profile_matches_the_reference(arrays):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "root_tools_equilibrium_run", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tools", "equilibrium_run.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    from planetmodel_sph_tpu_torch.tools import equilibrium_run as teq
    want = ref.radial_profile(_jax_state(arrays))
    got = teq.radial_profile(from_numpy(arrays, device="cpu"))
    assert got == want and len(got) == 16
    assert sum(r["count"] for r in got) >= TCFG.n


def _non_black(path):
    from PIL import Image
    a = np.asarray(Image.open(path).convert("RGB"))
    return a.shape, float((a.sum(axis=-1) > 0).mean())


@pytest.mark.parametrize("kw", [
    dict(), dict(color_by="id"), dict(color_by="material"),
    dict(color_by="vel", quiver=True, extent=30.0), dict(blocks=True)],
    ids=["rho", "id", "material", "quiver", "blocks"])
def test_render_png_like_the_reference(kw, arrays, tmp_path):
    ref_kw = dict(kw, blocks=JCFG) if kw.get("blocks") else kw
    got_kw = dict(kw, blocks=TCFG) if kw.get("blocks") else kw
    ref = str(tmp_path / "ref.png")
    got = str(tmp_path / "got.png")
    jrender.render_png(_jax_state(arrays), ref, **ref_kw)
    assert trender.render_png(from_numpy(arrays, device="cpu"), got,
                              **got_kw) == got
    for p in (ref, got):
        with open(p, "rb") as f:
            assert f.read(8) == PNG
    shape, share = _non_black(got)
    assert shape == (trender.CANVAS, trender.CANVAS, 3) and share > 0.5


def test_block_boxes_are_the_reference_groups(arrays):
    """The overlay's boxes: each group's live targets of the structure the
    reference builds from the same arrays."""
    st = jax.jit(lambda p, h, m: jstructure.build(p, h, m, JCFG))(
        arrays["pos"], arrays["h"], arrays["mass"])
    live = np.asarray(st.groups.live)
    p_b = arrays["pos"][np.asarray(st.groups.tgt_idx)].reshape(
        live.shape[0], -1, 3)
    want = [(p_b[g][live[g]][:, [0, 2]].min(0),
             p_b[g][live[g]][:, [0, 2]].max(0))
            for g in range(live.shape[0]) if live[g].any()]
    got = trender._block_boxes(from_numpy(arrays, device="cpu"), TCFG,
                               arrays["pos"], 0, 2)
    assert len(got) == len(want) > 1
    for (lo, hi), (wlo, whi) in zip(got, want):
        np.testing.assert_array_equal(lo, wlo)
        np.testing.assert_array_equal(hi, whi)


def test_render_to_a_file_object_with_nan_colours(arrays):
    a = dict(arrays, rho=arrays["rho"].copy())
    a["rho"][:7] = np.nan
    buf = io.BytesIO()
    trender.render_png(from_numpy(a, device="cpu"), buf)
    assert buf.getvalue()[:8] == PNG


def test_inferno_is_matplotlibs():
    import matplotlib
    t = np.linspace(0.0, 1.0, 33)
    want = np.array([matplotlib.colormaps["inferno"](x)[:3] for x in t])
    np.testing.assert_allclose(trender.inferno(t), want, atol=1e-4)
    mid = trender.inferno(np.linspace(0.0, 1.0, 101))
    ref = np.array([matplotlib.colormaps["inferno"](x)[:3]
                    for x in np.linspace(0.0, 1.0, 101)])
    assert np.abs(mid - ref).max() < 0.02


def test_assemble_gif(arrays, tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    st = from_numpy(arrays, device="cpu")
    for i in range(3):
        trender.render_png(st.replace(pos=st.pos * (1.0 + 0.1 * i)),
                           str(frames / f"frame_{i:05d}.png"), extent=40.0)
    out = trender.assemble_gif(str(frames), str(tmp_path / "a.gif"), fps=4)
    from PIL import Image
    with Image.open(out) as im:
        assert im.format == "GIF" and im.n_frames == 3
    with pytest.raises(ValueError, match="no frames"):
        trender.assemble_gif(str(tmp_path / "empty"), str(tmp_path / "b.gif"))


def test_config_fields_agree():
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
