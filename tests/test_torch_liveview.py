"""The port's live browser viewer (``planetmodel_sph_tpu_torch/utils/
liveview.py``): the two tests of ``tests/test_liveview.py`` on the port's
own state, config and diagnostics, on the CPU: the page, the PNG frame, the
diagnostics and the point-cloud frame are served; pause and resume, the
whitelisted knobs (folded into the config with ``cfg.replace``) and the
click-to-inspect fields. The point-cloud frame is byte for byte the
reference's on the same arrays."""

import json
import struct
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from planetmodel_sph_tpu import state as jstate
from planetmodel_sph_tpu.utils import liveview as jlive
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.models import ics, planet
from planetmodel_sph_tpu_torch.state import FIELDS
from planetmodel_sph_tpu_torch.utils import diagnostics, liveview
from planetmodel_sph_tpu_torch.utils.liveview import LiveViewer


@pytest.fixture(scope="module")
def primed():
    cfg = tc.default(n=128, radius=10.0, particle_radius=4.0,
                     gravity_solver="direct", neighbor_mode="dense",
                     block_n=128, adaptive_h=False)
    return cfg, planet.prime(ics.jupiter(cfg, device="cpu"), cfg)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read()


def test_liveview_serves_frame_and_diag(primed):
    cfg, state = primed
    v = LiveViewer(0)          # port 0: bind a free port
    try:
        d = diagnostics.measure(state, cfg)     # 0-dim tensors
        d["step"] = 7
        v.update(state, d)
        code, body = _get(v.port, "/")
        assert code == 200 and b"live view" in body.lower()
        code, png = _get(v.port, "/frame.png")
        assert code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        code, dj = _get(v.port, "/diag.json")
        got = json.loads(dj)
        assert got["step"] == 7
        assert abs(got["mass"] - 100.0) < 1e-3
        # WebGL point-cloud frame: header + f32 [scale, pos, color, h]
        code, pts = _get(v.port, "/points.bin")
        assert code == 200
        n, _ = struct.unpack("<II", pts[:8])
        assert n == 128
        assert len(pts) == 8 + 4 * (1 + 5 * n)
        # the interactive viewer is wired into the page
        code, body = _get(v.port, "/")
        assert b"points.bin" in body and b"getContext" in body
    finally:
        v.close()


def test_liveview_steering_and_inspect(primed):
    cfg, state = primed
    v = LiveViewer(0)
    try:
        v.update(state, {"step": 1})
        # pause -> visible in /diag.json and in control()
        assert _post(v.port, "/control", {"cmd": "pause"})[0] == 200
        assert json.loads(_get(v.port, "/diag.json")[1])["paused"] is True
        paused, overrides, dirty = v.control()
        assert paused and not dirty
        _post(v.port, "/control", {"cmd": "resume"})
        assert v.control()[0] is False
        # knobs: whitelisted keys fold into overrides, others are 400
        _post(v.port, "/control",
              {"cmd": "set", "overrides": {"vel_damping": 0.25,
                                           "av_alpha": 1.0,
                                           "av_beta": 2.0}})
        paused, overrides, dirty = v.control()
        assert dirty and overrides == {"vel_damping": 0.25,
                                       "av_alpha": 1.0, "av_beta": 2.0}
        assert cfg.replace(**overrides).vel_damping == 0.25
        assert v.control()[2] is False          # dirty flag cleared
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(v.port, "/control",
                  {"cmd": "set", "overrides": {"dt": 99.0}})
        assert e.value.code == 400
        # click-to-inspect: per-particle fields by index
        code, body = _get(v.port, "/inspect.json?i=5")
        info = json.loads(body)
        assert code == 200 and info["index"] == 5
        assert len(info["pos"]) == 3 and info["rho"] > 0.0
        assert "n_neighbors" in info
        assert "error" in json.loads(_get(v.port,
                                          "/inspect.json?i=999")[1])
        # the steering UI is wired into the page
        body = _get(v.port, "/")[1]
        assert b"/control" in body and b"inspect.json" in body
    finally:
        v.close()


@pytest.mark.parametrize("materials", [1, 2])
def test_points_payload_is_the_references(primed, materials):
    _, state = primed
    arrays = {k: getattr(state, k).numpy() for k in FIELDS}
    arrays["matid"] = (np.arange(state.n) % materials).astype(np.int32)
    ref = jlive._points_payload(jstate.ParticleState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    assert liveview._points_payload(arrays) == ref
