"""Roofline of the 100k block pipeline: the card's ceilings against the
modeled floor (PyTorch port of ``tools/roofline.py``).

    python -m planetmodel_sph_tpu_torch.tools.roofline [--ck STATE]
        [--n N] [--smoke] [--steps 64] [--json OUT] [--preset k=v,...]
        [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given. Measures primitive
rates (host dispatch latency, the device-memory stream, the f32 FMA rate
through the ``probe_fma`` kernel, the fixed cost of a launch through
``probe_launch``, as an eager wrapper call and inside a CUDA graph), loads
the production operating point (the settled state), counts the pair-slot
and gather work of one force evaluation, and prints the modeled
per-step floor beside the measured step time and the kernel launches a
step actually made.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from .. import config as config_mod
from ..models import ics, planet
from ..ops import structure
from ..ops.cuda import launch as launch_mod
from ..ops.cuda import probes
from ..state import resolve_device
from ..utils import checkpoint

SETTLED = "docs/results/drift100k_r5ship/state.psph"
# FMA reps of the rate measurement on the card: at the reference's 512 the
# chain is some 8 us of work, less than one launch; at 32768 it is some
# 0.5 ms and the launch under 5 % of the call
VPU_RATE_REPS = 32768


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chained(one, x, k, dev):
    """Seconds per call of k data-dependent calls x = one(x), after a
    warm-up call of the same shape, from a synchronize to a synchronize."""
    y = one(x)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(k):
        y = one(y)
    _sync(dev)
    return (time.perf_counter() - t0) / k


# ---------------------------------------------------------------------------
# primitive ceilings
# ---------------------------------------------------------------------------

def measure_dispatch(k=64, device="cuda"):
    """Host seconds from one small PyTorch call to its value on the host
    (a sum of 1,024 floats, then ``.item()``), median over k after one
    warm-up: the eager counterpart of the reference's fixed cost of a
    jitted call."""
    dev = resolve_device(device)
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    x.sum().item()
    times = []
    for _ in range(k):
        t0 = time.perf_counter()
        x.sum().item()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure_hbm(k=32, mb=512, device="cuda"):
    """Device-memory stream: one elementwise call per step over `mb` MB
    (``torch.add(a, a, alpha=1e-7, out=b)``, buffers alternating).
    Returns read + write bytes/s."""
    dev = resolve_device(device)
    n = mb * 1024 * 1024 // 4
    bufs = [torch.ones((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.float32, device=dev)]
    state = {"i": 0}

    def one(_):
        a, b = bufs[state["i"]], bufs[1 - state["i"]]
        torch.add(a, a, alpha=1e-7, out=b)
        state["i"] ^= 1
        return b

    dt = chained(one, None, k, dev)
    return 2 * n * 4 / dt


def measure_vpu(k=16, reps=512, b=256, lanes=512, device="cuda"):
    """f32 FMA-chain operations/s through ``probe_fma``: k chained calls
    of 8 * reps operations per element on [b, lanes]."""
    dev = resolve_device(device)
    x = torch.full((b, lanes), 1.0000001, dtype=torch.float32, device=dev)
    dt = chained(lambda v: probes.probe_fma(v, reps), x, k, dev)
    return 8 * reps * b * lanes / dt


def measure_launch(k=256, device="cuda"):
    """The cost of one launch, two ways: {"eager_s": seconds per wrapper
    call of a chain of k ``probe_launch`` calls, each on the previous
    output (k + 1 launches with the warm-up), "graph_s": seconds per
    launch of the same chain captured once in a CUDA graph and replayed
    (:func:`graph_launch`; None on the CPU, which has no graphs)}. The
    eager number is the host's cost of a wrapper call, the one the
    modeled floor charges; the graphed one is the counterpart of the
    reference's chain of launches inside one jitted scan."""
    dev = resolve_device(device)
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    eager = chained(probes.probe_launch, x, k, dev)
    return {"eager_s": eager,
            "graph_s": graph_launch(k, dev) if dev.type == "cuda" else None}


def graph_launch(k=256, device="cuda", replays=20):
    """Seconds per launch of a chain of k ``probe_launch`` calls captured
    once in a ``torch.cuda.CUDAGraph`` and replayed `replays` times after
    one warm-up replay, from a synchronize to a synchronize. The wrapper
    launches (and counts) one warm-up call outside the capture and k calls
    while capturing; a replay calls no wrapper. Card only."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"graph_launch: a CUDA graph needs a card, not "
                           f"{dev}")
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        probes.probe_launch(x)              # loads the kernel
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = x
        for _ in range(k):
            y = probes.probe_launch(y)
    graph.replay()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(replays):
        graph.replay()
    _sync(dev)
    return (time.perf_counter() - t0) / (replays * k)


# ---------------------------------------------------------------------------
# per-step work accounting at the operating point
# ---------------------------------------------------------------------------

def count_work(cfg, st):
    """Slot and byte counts one force evaluation actually issues (the
    reference's arithmetic, on the port's BlockStructure)."""
    bsz, sub, chunk = cfg.nbr_group_size, cfg.nbr_sub, cfg.block_chunk
    ceil_c = lambda nv: float(((nv.long() + chunk - 1) // chunk
                               * chunk).sum())
    g = st.groups.live.shape[0]

    nv_sph = structure._sph_nv(st, cfg)
    sph_slots = ceil_c(nv_sph) * bsz
    nv_p2p = torch.clamp(st.n_p2p, max=cfg.p2p_window) * sub
    p2p_slots = ceil_c(nv_p2p) * bsz
    nv_ring = torch.clamp(st.n_m2p, max=cfg.m2p_window)
    ring_slots = ceil_c(nv_ring) * bsz
    npad = st.accept.shape[1]
    far_slots = float(g * npad) * bsz
    blk_slots = 0.0
    if cfg.sg_blocks > 1:
        nv_blk = torch.clamp(st.n_blk, max=cfg.blk_window)
        blk_slots = ceil_c(nv_blk) * bsz

    # window gathers: write [G, S] once + kernel reads it once; the packed
    # source read is ~S_window rows (counted as its bytes)
    sph_fields = 4 if cfg.grad_p_mode == "grad_h" else 5
    sph_w = (ceil_c(nv_sph) if cfg.sph_exact_window
             else g * structure._nbpad(cfg.nbr_window * sub, chunk))
    p2p_w = g * structure._nbpad(cfg.p2p_window * sub, chunk)
    p2p_fields = 4 if cfg.softening_mode == "receiver_h" else 5
    gather_bytes = 4 * (
        sph_w * (sph_fields + 2)            # geom (+cc extra row, ~2 rw)
        + p2p_w * p2p_fields) * 2           # write + read back
    return {
        "groups": int(g),
        "sph_slots": sph_slots, "p2p_slots": p2p_slots,
        "ring_slots": ring_slots, "far_slots": far_slots,
        "blk_slots": blk_slots,
        "gather_bytes": gather_bytes,
    }


# per-pair-slot f32 operation counts of the reference's kernel bodies (its
# ops/pallas/groups2.py; where/select/compare = 1 op, accumulator adds
# included): pass 1 symmetric evaluates W at both h (38), grad-h one W +
# dW/dh (26); p2p Dyer-Ip inner + outer, min-h softening; mono +28 for the
# quadrupole correction
OPS = {"pass1_sym": 38, "pass1_gradh": 26, "pass2": 40, "p2p": 38,
       "mono": 12, "quad_extra": 28}


def modeled_floor(cfg, w, vpu, hbm, launch):
    """The reference's per-step floor in seconds: every sweep's operations
    at the FMA rate, the gathers' bytes at the stream rate, three launches
    at `launch` seconds each (the eager wrapper call's cost) and the
    amortized h-solve. Returns {part: seconds} with 'total'."""
    p1 = OPS["pass1_gradh" if cfg.grad_p_mode == "grad_h"
             else "pass1_sym"]
    mono = OPS["mono"] + (OPS["quad_extra"]
                          if cfg.multipole_order >= 2 else 0)
    ops = (w["sph_slots"] * (p1 + OPS["pass2"])
           + w["p2p_slots"] * OPS["p2p"]
           + (w["ring_slots"] + w["far_slots"] + w["blk_slots"]) * mono)
    out = {"vpu": ops / vpu, "hbm": w["gather_bytes"] / hbm,
           "launch": 3 * launch,
           "amort": (cfg.h_newton_iters * w["sph_slots"] * p1 / vpu
                     ) / max(1, cfg.rebuild_every)}
    out["total"] = sum(out.values())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="roofline")
    ap.add_argument("--ck", default=SETTLED,
                    help="the operating point's state (PSPH1 or npz)")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny-n smoke test of the accounting")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--json", default=None)
    ap.add_argument("--preset", default=None,
                    help="extra jupiter_100k overrides, k=v comma list")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    kw = dict(grad_p_mode="grad_h", h_mode="newton")
    if args.preset:
        kw.update(config_mod.parse_overrides(args.preset.split(",")))
    if args.smoke:
        cfg = config_mod.SimConfig(
            n=2048, neighbor_mode="grid", gravity_solver="tree",
            nbr_group_level=3, nbr_window=128, p2p_window=128,
            m2p_window=128, rebuild_every=4, **kw)
        state = planet.prime(ics.jupiter(cfg, device=dev),
                             cfg.replace(rebuild_every=1))
    else:
        cfg = config_mod.jupiter_100k(n=args.n, **kw)
        state, _, _ = checkpoint.load(args.ck, device=dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)

    # --- primitive ceilings ---
    reps = 64 if args.smoke or dev.type == "cpu" else VPU_RATE_REPS
    disp = measure_dispatch(device=dev)
    hbm = measure_hbm(mb=64 if args.smoke else 512, device=dev)
    vpu = measure_vpu(reps=reps, device=dev)
    lat = measure_launch(k=32 if args.smoke else 256, device=dev)
    launch = lat["eager_s"]
    graphed = ("not measured (no CUDA graph on the CPU)"
               if lat["graph_s"] is None
               else f"{lat['graph_s'] * 1e6:8.2f} us")
    print(f"dispatch latency      {disp*1e6:8.2f} us/call")
    print(f"memory stream (r+w)   {hbm/1e9:8.1f} GB/s")
    print(f"f32 FMA-chain         {vpu/1e12:8.2f} Top/s (reps={reps})")
    print(f"launch fixed          {launch*1e6:8.2f} us (eager wrapper call)")
    print(f"launch in a graph     {graphed}", flush=True)

    # --- operating-point work ---
    st = structure.build(state.pos, state.h, state.mass, cfg)
    w = count_work(cfg, st)
    n = cfg.n
    print(f"\nwork per force eval at n={n} (slots include chunk padding):")
    for key in ("sph_slots", "p2p_slots", "ring_slots", "far_slots",
                "blk_slots"):
        print(f"  {key:12s} {w[key]/1e6:10.1f} M   "
              f"({w[key]/n:7.0f} per particle)")
    print(f"  gather bytes {w['gather_bytes']/1e6:10.1f} MB")

    fl = modeled_floor(cfg, w, vpu, hbm, launch)
    print("\nmodeled per-step floor:")
    print(f"  f32 sweeps        {fl['vpu']*1e3:8.2f} ms")
    print(f"  gather bytes      {fl['hbm']*1e3:8.2f} ms")
    print(f"  launches          {fl['launch']*1e3:8.2f} ms")
    print(f"  h-solve amortized {fl['amort']*1e3:8.2f} ms")
    print(f"  TOTAL             {fl['total']*1e3:8.2f} ms "
          f"= {1/fl['total']:.1f} steps/s ceiling", flush=True)

    # --- measured step time on the same config ---
    planet.run(state, cfg, args.steps)
    _sync(dev)
    launch_mod.reset_launches()
    t0 = time.perf_counter()
    planet.run(state, cfg, args.steps)
    _sync(dev)
    dt = (time.perf_counter() - t0) / args.steps
    per_step = {k: v / args.steps for k, v in launch_mod.LAUNCHES.items()
                if v}
    print(f"\nmeasured          {dt*1e3:8.2f} ms/step = {1/dt:.1f} steps/s "
          f"({n/dt/1e6:.2f} M particle-steps/s)")
    print(f"efficiency vs modeled floor: {fl['total']/dt*100:.0f}%")
    print(f"kernel launches per step {sum(per_step.values()):.3f} (the "
          f"model counts 3): {per_step}", flush=True)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": name, "dispatch_s": disp, "hbm_Bps": hbm,
                       "vpu_ops": vpu, "vpu_reps": reps, "launch_s": launch,
                       "launch_graph_s": lat["graph_s"],
                       "work": w, "floor": fl, "floor_s": fl["total"],
                       "measured_s": dt, "launches_per_step": per_step},
                      f, indent=1)
        print(f"json -> {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
