"""Trace the production 100k pipeline (PyTorch port of the root
``tools/trace_run.py``, which captured a JAX xplane trace).

Runs a warm chunk of ``jupiter_100k(grad_p_mode="grad_h",
h_mode="newton")`` (with the reference's ``--preset k=v,...`` overrides)
from a state file: once to warm up, once timed with CUDA events ("warm: X
ms/step = Y steps/s"), once under ``utils/profiling.trace`` with Python
frames; prints where the Chrome trace went, writes the untraced time
beside it (``untraced.json``, from which ``tools.trace_summary`` gives the
untraced run's idle share: the profiler slows the host), then prints the
summary (``tools.trace_summary --top 40``). The state file's default is the
in-repo settled state (the reference's default file is not in the repo);
without a file, the preset's initial conditions, primed. Runs on the card
unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.trace_run --steps 16 \\
        --out out/trace_run
    python -m planetmodel_sph_tpu_torch.tools.trace_summary out/trace_run \\
        --by-category
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .. import config as config_mod
from ..models import ics, planet
from ..state import resolve_device
from ..utils import checkpoint, profiling
from . import trace_summary

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CK = os.path.join(_ROOT, "docs", "results", "drift100k_r5ship",
                          "state.psph")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ck", default=DEFAULT_CK,
                    help="a state file (default: the in-repo settled "
                         "state); a missing file means the preset's ICs")
    ap.add_argument("--out", default=None,
                    help="the trace's directory (default: "
                         "utils/profiling.default_logdir())")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--preset", default=None,
                    help="extra jupiter_100k overrides, k=v comma list")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    kw = dict(grad_p_mode="grad_h", h_mode="newton")
    if args.preset:
        for item in args.preset.split(","):
            k, v = item.split("=")
            kw[k] = config_mod.parse_override(k, v)
    state = None
    if args.ck and os.path.exists(args.ck):
        state, _, _ = checkpoint.load(args.ck, device=dev)
        kw.setdefault("n", state.n)
    cfg = config_mod.jupiter_100k(**kw)
    config_mod.check_slice(cfg)
    if state is None:
        state = planet.prime(ics.jupiter(cfg, device=dev),
                             cfg.replace(rebuild_every=1))

    dt, _ = profiling.seconds_per_call(
        lambda: planet.run(state, cfg, args.steps), dev)
    dt /= args.steps
    print(f"warm: {dt*1e3:.4f} ms/step = {1/dt:.4f} steps/s on {dev}",
          flush=True)

    with profiling.trace(args.out, with_stack=True) as logdir:
        out = planet.run(state, cfg, args.steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = os.path.join(logdir, "trace.json")
    with open(os.path.join(logdir, trace_summary.UNTRACED), "w") as f:
        json.dump(dict(steps=args.steps, ms_per_step=dt * 1e3), f)
    print(f"trace -> {path}", flush=True)
    del out
    return trace_summary.main([path, "--top", "40"])


if __name__ == "__main__":
    raise SystemExit(main())
