"""Live browser viewer for a running simulation (PyTorch port).

A copy of ``planetmodel_sph_tpu.utils.liveview`` on the standard library:
``cli run --serve PORT`` starts a small in-process HTTP server, the run loop
pushes each frame and the latest diagnostics into it, and a browser at
``http://localhost:PORT`` shows the evolving planet two ways:

- an interactive WebGL point cloud (drag to orbit, wheel to zoom,
  per-particle colour from log-density or material id, point size from
  the smoothing length; raw binary frames over ``/points.bin``), and
- the projection PNG of ``utils/render.py`` (``/frame.png``) with live
  conserved quantities (``/diag.json``).

The page can pause and resume the run, change the ``STEER_KNOBS`` between
chunks (``POST /control``; the run loop folds them into its config with
``cfg.replace``) and inspect a clicked particle (``/inspect.json``). The
viewer takes tensors from any device: :meth:`LiveViewer.update` moves each
field to the host once (``.cpu().numpy()``).
"""

from __future__ import annotations

import io
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = b"""<!doctype html>
<html><head><title>planetmodel-sph-tpu live</title><style>
body { background:#101014; color:#ddd; font:14px monospace; margin:0; }
#wrap { display:flex; flex-wrap:wrap; align-items:flex-start; }
canvas { margin:8px; border:1px solid #333; background:#07070a;
         touch-action:none; }
img { margin:8px; border:1px solid #333; max-width:min(44vw,520px); }
#diag { margin:8px; padding:8px; white-space:pre; }
h1 { font-size:16px; margin:8px; color:#8cf; }
#hint { color:#678; margin:0 8px 8px; }
</style></head><body>
<h1>planetmodel-sph-tpu &mdash; live view</h1>
<p id="hint">drag: orbit &middot; wheel: zoom &middot; click: inspect
particle &middot; color: log&nbsp;&rho; (or material id) &middot; size:
smoothing length</p>
<div id="bar" style="margin:8px">
  <button id="pause">pause</button>
  <span style="margin-left:12px">vel_damping
    <input id="k_vel_damping" type="number" step="0.01" min="0"
           style="width:70px"></span>
  <span style="margin-left:8px">av_alpha
    <input id="k_av_alpha" type="number" step="0.1" min="0"
           style="width:70px"></span>
  <button id="apply" style="margin-left:8px">apply knobs</button>
  <span id="pstate" style="margin-left:12px;color:#8cf"></span>
</div>
<div id="wrap">
  <canvas id="gl" width="760" height="700"></canvas>
  <div><img id="frame" src="/frame.png"><div id="diag"></div>
       <div id="inspect" style="margin:8px;padding:8px;white-space:pre;
            color:#cfa"></div></div>
</div>
<script>
const KEYS = ["step","total_energy","kinetic_energy","potential_energy",
  "internal_energy","momentum_mag","angular_momentum_z","radius_rms",
  "neighbors_avg","h_avg","rho_max","vel_max","steps_per_sec"];

// ---- minimal WebGL1 point-cloud renderer (no libraries) ----
const cv = document.getElementById("gl");
const gl = cv.getContext("webgl", {antialias:false});
let nPts = 0, theta = 0.5, phi = 0.35, dist = 3.0, scale = 1.0;
if (gl) {
  const vs = `attribute vec3 aPos; attribute float aVal;
    attribute float aH; uniform mat4 uMVP; uniform float uPt;
    varying float vVal;
    void main(){ gl_Position = uMVP * vec4(aPos, 1.0);
      gl_PointSize = clamp(uPt * aH / max(gl_Position.w, 1e-3), 1.5, 14.0);
      vVal = aVal; }`;
  const fs = `precision mediump float; varying float vVal;
    void main(){
      vec2 c = gl_PointCoord - 0.5;
      if (dot(c, c) > 0.25) discard;
      float t = clamp(vVal, 0.0, 1.0);            // blue->cyan->yellow->red
      vec3 col = t < 0.5 ? mix(vec3(0.15,0.25,0.9), vec3(0.2,0.9,0.9), t*2.0)
                         : mix(vec3(0.2,0.9,0.9), vec3(1.0,0.85,0.15),
                               (t-0.5)*2.0);
      col = mix(col, vec3(1.0,0.25,0.1), smoothstep(0.85, 1.0, t));
      gl_FragColor = vec4(col, 0.85); }`;
  const sh = (type, src) => { const s = gl.createShader(type);
    gl.shaderSource(s, src); gl.compileShader(s); return s; };
  const prog = gl.createProgram();
  gl.attachShader(prog, sh(gl.VERTEX_SHADER, vs));
  gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(prog); gl.useProgram(prog);
  gl.enable(gl.BLEND); gl.blendFunc(gl.SRC_ALPHA, gl.ONE);
  const bufs = {pos: gl.createBuffer(), val: gl.createBuffer(),
                h: gl.createBuffer()};
  const attr = (name, buf, size) => { const a = gl.getAttribLocation(prog,
      name); gl.bindBuffer(gl.ARRAY_BUFFER, buf);
    gl.enableVertexAttribArray(a);
    gl.vertexAttribPointer(a, size, gl.FLOAT, false, 0, 0); };
  const uMVP = gl.getUniformLocation(prog, "uMVP");
  const uPt = gl.getUniformLocation(prog, "uPt");

  cv.onpointerdown = e => { cv.setPointerCapture(e.pointerId);
    cv._drag = [e.clientX, e.clientY]; };
  cv.onpointerup = () => { cv._drag = null; };
  cv.onpointermove = e => { if (!cv._drag) return;
    theta += (e.clientX - cv._drag[0]) * 0.008;
    phi = Math.max(-1.5, Math.min(1.5, phi + (e.clientY - cv._drag[1])
                                   * 0.008));
    cv._drag = [e.clientX, e.clientY]; };
  cv.onwheel = e => { e.preventDefault();
    dist *= Math.pow(1.1, Math.sign(e.deltaY)); };

  window.drawCloud = function () {
    gl.viewport(0, 0, cv.width, cv.height);
    gl.clearColor(0.027, 0.027, 0.04, 1.0);
    gl.clear(gl.COLOR_BUFFER_BIT);
    if (!nPts) return;
    // column-major MVP = perspective * lookAt(orbit camera at origin)
    const ct = Math.cos(theta), st = Math.sin(theta);
    const cp = Math.cos(phi), sp = Math.sin(phi);
    const ex = dist * cp * st, ey = dist * sp, ez = dist * cp * ct;
    let zx = ex, zy = ey, zz = ez;                    // forward = eye - 0
    const zl = Math.hypot(zx, zy, zz); zx /= zl; zy /= zl; zz /= zl;
    let xx = zz, xy = 0, xz = -zx;                    // right = up x z
    const xl = Math.hypot(xx, xy, xz) || 1; xx /= xl; xz /= xl;
    const yx = zy * xz - zz * xy, yy = zz * xx - zx * xz,
          yz = zx * xy - zy * xx;
    const f = 2.0, near = 0.05, far = 50.0, a = cv.width / cv.height;
    const k = 1.0 / scale;
    // M = P * V * S  (S = uniform 1/scale so data fits the unit ball)
    const vtx = [xx*k, yx*k, zx*k, 0,  xy*k, yy*k, zy*k, 0,
                 xz*k, yz*k, zz*k, 0,
                 -(xx*ex+xy*ey+xz*ez), -(yx*ex+yy*ey+yz*ez),
                 -(zx*ex+zy*ey+zz*ez), 1];
    const P = [f/a,0,0,0, 0,f,0,0,
               0,0,-(far+near)/(far-near),-1,
               0,0,-2*far*near/(far-near),0];
    const M = new Float32Array(16);
    for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++) {
      let s = 0;
      for (let i = 0; i < 4; i++) s += P[i*4+r] * vtx[c*4+i];
      M[c*4+r] = s;
    }
    gl.uniformMatrix4fv(uMVP, false, M);
    gl.uniform1f(uPt, 140.0 / (scale * dist));
    window._lastM = M;
    gl.drawArrays(gl.POINTS, 0, nPts);
  };

  // click (not drag) -> project every point with the last MVP, pick the
  // nearest on screen, fetch its fields from /inspect.json
  cv.addEventListener("pointerdown",
    e => { cv._down = [e.clientX, e.clientY]; });
  cv.addEventListener("pointerup", async e => {
    if (!cv._down || !window._cloudPos || !window._lastM) return;
    const moved = Math.hypot(e.clientX - cv._down[0],
                             e.clientY - cv._down[1]);
    cv._down = null;
    if (moved > 4) return;                       // that was an orbit drag
    const r = cv.getBoundingClientRect();
    const cx = (e.clientX - r.left) / r.width * 2 - 1;
    const cy = 1 - (e.clientY - r.top) / r.height * 2;
    const M = window._lastM, p = window._cloudPos;
    let best = -1, bd = 0.0016;                  // ~2% NDC pick radius
    for (let i = 0; i < nPts; i++) {
      const x = p[3*i], y = p[3*i+1], z = p[3*i+2];
      const w = M[3]*x + M[7]*y + M[11]*z + M[15];
      if (w < 0.05) continue;
      const sx = (M[0]*x + M[4]*y + M[8]*z + M[12]) / w;
      const sy = (M[1]*x + M[5]*y + M[9]*z + M[13]) / w;
      const d = (sx-cx)*(sx-cx) + (sy-cy)*(sy-cy);
      if (d < bd) { bd = d; best = i; }
    }
    const el = document.getElementById("inspect");
    if (best < 0) { el.textContent = ""; return; }
    try {
      const info = await (await fetch("/inspect.json?i=" + best,
                                      {cache:"no-store"})).json();
      el.textContent = "particle " + best + "\\n" + Object.entries(info)
        .filter(([k]) => k !== "index")
        .map(([k, v]) => k.padEnd(12) + (Array.isArray(v)
              ? v.map(c => c.toPrecision(5)).join(", ")
              : (typeof v === "number" ? v.toPrecision(6) : v)))
        .join("\\n");
    } catch (err) { el.textContent = "inspect failed: " + err; }
  });

  window.loadCloud = async function () {
    const buf = await (await fetch("/points.bin", {cache:"no-store"}))
      .arrayBuffer();
    if (buf.byteLength < 8) return;
    const head = new Uint32Array(buf, 0, 2);
    const n = head[0];
    if (!n) return;
    const f32 = new Float32Array(buf, 8);
    scale = f32[0] || 1.0;
    const pos = f32.subarray(1, 1 + 3 * n);
    window._cloudPos = pos;                      // for click picking
    const val = f32.subarray(1 + 3 * n, 1 + 4 * n);
    const hh = f32.subarray(1 + 4 * n, 1 + 5 * n);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufs.pos);
    gl.bufferData(gl.ARRAY_BUFFER, pos, gl.DYNAMIC_DRAW);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufs.val);
    gl.bufferData(gl.ARRAY_BUFFER, val, gl.DYNAMIC_DRAW);
    gl.bindBuffer(gl.ARRAY_BUFFER, bufs.h);
    gl.bufferData(gl.ARRAY_BUFFER, hh, gl.DYNAMIC_DRAW);
    attr("aPos", bufs.pos, 3); attr("aVal", bufs.val, 1);
    attr("aH", bufs.h, 1);
    nPts = n;
  };
  (function anim() { window.drawCloud(); requestAnimationFrame(anim); })();
  (async function poll() {
    try { await window.loadCloud(); } catch (e) {}
    setTimeout(poll, 700);
  })();
}

// ---- runtime steering (pause/resume + live knobs) ----
const post = body => fetch("/control", {method:"POST",
  headers:{"Content-Type":"application/json"}, body:JSON.stringify(body)});
let paused = false;
document.getElementById("pause").onclick = async () => {
  paused = !paused;
  await post({cmd: paused ? "pause" : "resume"});
  document.getElementById("pause").textContent =
    paused ? "resume" : "pause";
};
document.getElementById("apply").onclick = async () => {
  const ov = {};
  for (const k of ["vel_damping", "av_alpha"]) {
    const v = document.getElementById("k_" + k).value;
    if (v !== "") ov[k] = parseFloat(v);
    if (k === "av_alpha" && v !== "") ov["av_beta"] = 2 * parseFloat(v);
  }
  await post({cmd: "set", overrides: ov});
};

async function tick() {
  try {
    const d = await (await fetch("/diag.json", {cache:"no-store"})).json();
    document.getElementById("diag").textContent = KEYS
      .filter(k => k in d)
      .map(k => k.padEnd(20) + (typeof d[k] === "number"
            ? d[k].toPrecision(6) : d[k]))
      .join("\\n");
    paused = !!d.paused;
    document.getElementById("pause").textContent =
      paused ? "resume" : "pause";
    document.getElementById("pstate").textContent = paused
      ? "PAUSED (server holds between chunks)" : "";
    const img = document.getElementById("frame");
    img.src = "/frame.png?t=" + Date.now();
  } catch (e) {}
  setTimeout(tick, 1000);
}
tick();
</script></body></html>
"""


def _points_payload(fields: dict) -> bytes:
    """Binary point-cloud frame: uint32 n, uint32 reserved, then f32
    [scale, pos[3n], color[n], h[n]].

    Color is the normalized log-density unless the state carries more than
    one material id, in which case materials get distinct ramp positions.
    Scale is the 95th-percentile radius, so the unit-ball camera frames the
    planet rather than escaped halo particles. `fields`: host arrays."""
    import numpy as np

    pos = np.asarray(fields["pos"], np.float32)
    n = pos.shape[0]
    hh = np.asarray(fields["h"], np.float32)
    matid = fields.get("matid")
    if matid is not None and np.unique(matid).size > 1:
        val = (matid.astype(np.float32) / max(float(matid.max()), 1.0))
    else:
        rho = np.maximum(np.asarray(fields["rho"], np.float32), 1e-30)
        lg = np.log10(rho)
        lo, hi = np.percentile(lg, 5.0), np.percentile(lg, 99.5)
        val = ((lg - lo) / max(hi - lo, 1e-6)).astype(np.float32)
    r = np.linalg.norm(pos, axis=1)
    scale = float(np.percentile(r, 95.0)) or 1.0
    return (struct.pack("<II", n, 0)
            + np.float32(scale).tobytes()
            + pos.tobytes() + val.tobytes() + hh.tobytes())


# Live-tunable SimConfig knobs. Whitelisted: each is physics-safe to change
# between diagnostic chunks (the run loop takes cfg.replace; nothing is
# compiled again).
STEER_KNOBS = {"vel_damping": float, "av_alpha": float, "av_beta": float}


class LiveViewer:
    """Holds the latest frame/diagnostics; serves them over HTTP.

    Runtime steering: the page can pause and resume the run, nudge the
    ``STEER_KNOBS``, and click any particle to inspect it. The run loop polls :meth:`control` between chunks and
    :meth:`update` publishes per-particle fields for ``/inspect.json``.
    """

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._points: bytes = b""
        self._diag: dict = {}
        self._fields: dict = {}        # numpy per-particle field arrays
        self._paused = False
        self._overrides: dict = {}
        self._dirty = False
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # keep the CLI output clean
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path in ("/", "/index.html"):
                    body, ctype = _PAGE, "text/html"
                elif path == "/frame.png":
                    with viewer._lock:
                        body, ctype = viewer._png, "image/png"
                elif path == "/points.bin":
                    with viewer._lock:
                        body = viewer._points
                    ctype = "application/octet-stream"
                elif path == "/diag.json":
                    with viewer._lock:
                        d = dict(viewer._diag)
                        d["paused"] = viewer._paused
                        d.update({f"knob_{k}": v for k, v
                                  in viewer._overrides.items()})
                    body = json.dumps(d).encode()
                    ctype = "application/json"
                elif path == "/inspect.json":
                    try:
                        i = int(dict(p.split("=", 1) for p in
                                     query.split("&") if "=" in p)["i"])
                    except Exception:
                        self.send_error(400)
                        return
                    body = json.dumps(viewer.inspect(i)).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path.split("?")[0] != "/control":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    viewer._apply_control(req)
                except (ValueError, TypeError) as e:
                    self.send_error(400, str(e)[:100])
                    return
                body = b'{"ok": true}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.port = self._srv.server_address[1]   # resolved when port=0
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _apply_control(self, req: dict):
        cmd = req.get("cmd")
        with self._lock:
            if cmd == "pause":
                self._paused = True
            elif cmd == "resume":
                self._paused = False
            elif cmd == "set":
                for k, v in (req.get("overrides") or {}).items():
                    if k not in STEER_KNOBS:
                        raise ValueError(f"knob {k!r} is not steerable")
                    self._overrides[k] = STEER_KNOBS[k](v)
                self._dirty = True
            else:
                raise ValueError(f"unknown cmd {cmd!r}")

    def control(self):
        """(paused, overrides, dirty) snapshot for the run loop; clears
        the dirty flag (the loop applies overrides via cfg.replace)."""
        with self._lock:
            out = (self._paused, dict(self._overrides), self._dirty)
            self._dirty = False
            return out

    def inspect(self, i: int) -> dict:
        """Per-particle fields of the clicked index, from the host copies
        the last :meth:`update` made."""
        with self._lock:
            fields = self._fields
        if not fields:
            return {"error": "no state yet"}
        n = len(fields.get("rho", ()))
        if not 0 <= i < n:
            return {"error": f"index {i} out of range [0, {n})"}
        out = {"index": i}
        for k, v in fields.items():
            x = v[i]
            out[k] = [float(c) for c in x] if getattr(x, "ndim", 0) \
                else float(x)
        return out

    def update(self, state, diag: dict | None = None, **render_kw):
        """Render the state to the in-memory frame, publish its fields and
        the diagnostics (tensors or numbers)."""
        from . import render
        fields = {}
        for k in ("pos", "vel", "h", "rho", "pressure", "phi",
                  "n_neighbors", "n_direct", "n_approx", "u", "matid"):
            v = getattr(state, k, None)
            if v is not None:
                fields[k] = render.host_array(v)
        buf = io.BytesIO()
        render.render_png(state, buf, **render_kw)
        points = _points_payload(fields)
        with self._lock:
            self._png = buf.getvalue()
            self._points = points
            self._fields = fields
            if diag is not None:
                self._diag = {k: (float(v) if hasattr(v, "__float__") else v)
                              for k, v in diag.items()}

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()
