"""Point-sprite particle renderer (PNG) and animation assembly (PyTorch port).

Counterpart of ``planetmodel_sph_tpu.utils.render`` with the same calls and
options: each particle a disc whose size tracks its smoothing length, its
colour a field (the inferno ramp over the field's range), a stable random
base colour per particle (``color_by='id'``) or its material (with a
legend), an optional velocity quiver, and an optional overlay of the
Morton-block boxes of the current neighbour structure. The reference draws
with matplotlib; the port draws with PIL and numpy alone (the H100 machine
has no matplotlib), on a 770-pixel square canvas like the reference's 7 in
at 110 dpi: the black plot area, a colour bar, axis names and extents.
Every tensor goes to numpy once, at the top of :func:`render_png`.
"""

from __future__ import annotations

import glob
import os

import numpy as np

CANVAS = 770                 # the reference's figsize 7 in at 110 dpi
PLOT = (60, 24, 660, 624)    # the plot area: left, top, right, bottom
BAR = (676, 24, 694, 624)    # the colour bar
PX_PER_PT = 110.0 / 72.0
# matplotlib's inferno at 33 evenly spaced points
_INFERNO = np.array([
    (0.0015, 0.0005, 0.0139), (0.0140, 0.0112, 0.0719),
    (0.0423, 0.0281, 0.1411), (0.0820, 0.0433, 0.2153),
    (0.1293, 0.0473, 0.2908), (0.1834, 0.0403, 0.3550),
    (0.2383, 0.0366, 0.3964), (0.2908, 0.0456, 0.4186),
    (0.3415, 0.0623, 0.4294), (0.3915, 0.0809, 0.4331),
    (0.4412, 0.0993, 0.4316), (0.4910, 0.1172, 0.4256),
    (0.5409, 0.1347, 0.4151), (0.5907, 0.1526, 0.4003),
    (0.6401, 0.1714, 0.3811), (0.6887, 0.1922, 0.3576),
    (0.7357, 0.2159, 0.3302), (0.7805, 0.2433, 0.2995),
    (0.8224, 0.2752, 0.2661), (0.8605, 0.3119, 0.2306),
    (0.8943, 0.3534, 0.1936), (0.9232, 0.3994, 0.1552),
    (0.9470, 0.4492, 0.1153), (0.9654, 0.5022, 0.0739),
    (0.9784, 0.5579, 0.0349), (0.9860, 0.6158, 0.0256),
    (0.9879, 0.6753, 0.0653), (0.9841, 0.7361, 0.1295),
    (0.9746, 0.7977, 0.2063), (0.9606, 0.8591, 0.2980),
    (0.9476, 0.9174, 0.4107), (0.9545, 0.9659, 0.5404),
    (0.9884, 0.9984, 0.6449)])
_PALETTE = ("#b0633a", "#9b9b9b", "#e8d44d", "#7fd4ff", "#3a6fd8")


def _stable_colors(n: int, seed: int = 0):
    """Per-particle random base colours, stable across frames and steps."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.25, 1.0, size=(n, 3))


def inferno(t):
    """RGB in [0, 1] of the inferno ramp at t in [0, 1] (NaN stays NaN)."""
    x = np.clip(t, 0.0, 1.0) * (len(_INFERNO) - 1)
    return np.stack([np.interp(x, np.arange(len(_INFERNO)), _INFERNO[:, c])
                     for c in range(3)], axis=-1)


def _hex(c):
    return tuple(int(c[i:i + 2], 16) for i in (1, 3, 5))


def _rgba(rgb, alpha):
    return tuple(int(round(255 * v)) for v in rgb) + (int(255 * alpha),)


def host_array(x):
    """A tensor (any device) or array as a numpy array on the host."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def _block_boxes(state, cfg, pos, a0, a1):
    """The (lo, hi) corners, in the plotted axes, of each group's live
    targets in the structure ``ops/structure.build`` gives the state under
    `cfg` (built on the state's device: on the card it launches
    ``filter_sph`` where the config refines its windows)."""
    from ..ops import structure

    st = structure.build(state.pos, state.h, state.mass, cfg)
    grp = st.groups
    live = host_array(grp.live)
    p_b = pos[host_array(grp.tgt_idx)].reshape(live.shape[0], -1, 3)
    out = []
    for gi in range(live.shape[0]):
        if live[gi].any():
            pts = p_b[gi][live[gi]][:, [a0, a1]]
            out.append((pts.min(axis=0), pts.max(axis=0)))
    return out


def render_png(state, path, axis=(0, 1), extent: float | None = None,
               color_by: str = "rho", quiver: bool = False,
               quiver_max: int = 400, blocks=None):
    """Render one frame to `path` (a file name or a binary file object).

    color_by: any scalar or vector ParticleState field name (vectors use
    their norm), 'id' for stable per-particle random colours, or
    'material' for one colour per material id. quiver: velocity arrows on
    a subsample of at most about `quiver_max` particles. blocks: a
    SimConfig: overlay the boxes of the Morton blocks of the neighbour
    structure built under it."""
    from PIL import Image, ImageDraw, ImageFont

    pos = host_array(state.pos).astype(np.float64)
    h = host_array(state.h).astype(np.float64)
    field = None if color_by == "id" else host_array(getattr(
        state, "matid" if color_by == "material" else color_by))
    vel = host_array(state.vel) if quiver else None
    boxes = _block_boxes(state, blocks, pos, *axis) if blocks is not None \
        else []

    a0, a1 = axis
    if extent is None:
        extent = float(np.percentile(np.abs(pos[:, [a0, a1]]), 99.5)) \
            * 1.3 + 1e-6
    x0, y0, x1, y1 = PLOT
    scale = (x1 - x0) / (2.0 * extent)
    px = (pos[:, a0] + extent) * scale
    py = (extent - pos[:, a1]) * scale
    diam_pt = np.clip(40.0 * (h / max(extent, 1e-6)) * 7.0, 0.5, 60.0)
    rad = 0.5 * diam_pt * PX_PER_PT

    order = np.arange(pos.shape[0])
    legend, bar = [], None
    if color_by == "id":
        rgb = _stable_colors(pos.shape[0])
    elif color_by == "material":
        from ..ops import eos as eos_ops
        mid = field.astype(np.int64)
        order = np.argsort(-rad, kind="stable")   # large markers first
        pal = np.array([_hex(_PALETTE[i % len(_PALETTE)])
                        for i in range(len(eos_ops.MATERIAL_NAMES))]) / 255.0
        rgb = pal[mid]
        legend = [(_PALETTE[i % len(_PALETTE)], eos_ops.MATERIAL_NAMES[i])
                  for i in np.unique(mid)]
    else:
        c = field.astype(np.float64)
        if c.ndim > 1:
            c = np.linalg.norm(c, axis=-1)
        fin = np.isfinite(c)
        lo, hi = (float(c[fin].min()), float(c[fin].max())) if fin.any() \
            else (0.0, 1.0)
        rgb = inferno((c - lo) / (hi - lo if hi > lo else 1.0))
        order = order[fin]           # matplotlib leaves NaN colours out
        bar = (lo, hi)

    plot = Image.new("RGB", (x1 - x0, y1 - y0), (0, 0, 0))
    draw = ImageDraw.Draw(plot, "RGBA")
    for i in order:
        r = rad[i]
        draw.ellipse((px[i] - r, py[i] - r, px[i] + r, py[i] + r),
                     fill=_rgba(rgb[i], 0.6))
    if quiver:
        stride = max(1, pos.shape[0] // quiver_max)
        vx, vy = vel[::stride, a0], -vel[::stride, a1]
        vmax = float(np.max(np.hypot(vx, vy))) if vx.size else 0.0
        k = 0.06 * (x1 - x0) / vmax if vmax > 0.0 else 0.0
        arrow = _rgba(np.array(_hex("#60c0ff")) / 255.0, 0.8)
        for xa, ya, dx, dy in zip(px[::stride], py[::stride], vx * k,
                                  vy * k):
            draw.line((xa, ya, xa + dx, ya + dy), fill=arrow, width=1)
            draw.ellipse((xa + dx - 1, ya + dy - 1, xa + dx + 1,
                          ya + dy + 1), fill=arrow)
    box_col = _rgba(np.array(_hex("#40ff90")) / 255.0, 0.55)
    for lo, hi in boxes:
        draw.rectangle(((lo[0] + extent) * scale, (extent - hi[1]) * scale,
                        (hi[0] + extent) * scale, (extent - lo[1]) * scale),
                       outline=box_col, width=1)

    img = Image.new("RGB", (CANVAS, CANVAS), (255, 255, 255))
    img.paste(plot, (x0, y0))
    d = ImageDraw.Draw(img)
    font = ImageFont.load_default()
    ink = (0, 0, 0)
    d.rectangle((x0 - 1, y0 - 1, x1, y1), outline=ink)
    d.text(((x0 + x1) // 2, y1 + 22), "xyz"[a0], fill=ink, font=font)
    d.text((x0 - 40, (y0 + y1) // 2), "xyz"[a1], fill=ink, font=font)
    for v, xt in ((-extent, x0), (extent, x1 - 40)):
        d.text((xt, y1 + 4), f"{v:.3g}", fill=ink, font=font)
    d.text((4, y0), f"{extent:.3g}", fill=ink, font=font)
    d.text((4, y1 - 12), f"{-extent:.3g}", fill=ink, font=font)
    if bar is not None:
        bx0, by0, bx1, by1 = BAR
        ramp = inferno(np.linspace(1.0, 0.0, by1 - by0))
        col = (255 * ramp).astype(np.uint8)[:, None, :].repeat(bx1 - bx0, 1)
        img.paste(Image.fromarray(col, "RGB"), (bx0, by0))
        d.rectangle((bx0 - 1, by0 - 1, bx1, by1), outline=ink)
        d.text((bx1 + 4, by0), f"{bar[1]:.4g}", fill=ink, font=font)
        d.text((bx1 + 4, by1 - 12), f"{bar[0]:.4g}", fill=ink, font=font)
        d.text((bx1 + 4, (by0 + by1) // 2), color_by, fill=ink, font=font)
    for k, (colour, name) in enumerate(legend):
        yk = y0 + 8 + 16 * k
        d.ellipse((x1 - 110, yk, x1 - 100, yk + 10), fill=_hex(colour))
        d.text((x1 - 94, yk - 1), name, fill=(255, 255, 255), font=font)
    img.save(path, format="PNG")
    return path


def assemble_gif(frames, out_path: str, fps: float = 10.0) -> str:
    """Assemble PNG frames into an animated GIF.

    `frames`: a directory containing frame_*.png, or an explicit list of
    paths. Uses PIL only."""
    from PIL import Image

    if isinstance(frames, str):
        paths = sorted(glob.glob(os.path.join(frames, "*.png")))
    else:
        paths = list(frames)
    if not paths:
        raise ValueError(f"no frames found for {out_path}")
    imgs = [Image.open(p).convert("P", palette=Image.ADAPTIVE) for p in paths]
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000.0 / fps), loop=0)
    return out_path
