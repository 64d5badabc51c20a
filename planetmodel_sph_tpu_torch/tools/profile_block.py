"""The stages of the 100k block pipeline, one by one (PyTorch port of the
root ``tools/profile_block.py``): ``structure.forces`` whole, the rebuild,
the sorts of ``_prep_ctx``, the two row gathers, the Newton h-solve, the
three kernels of the production sweeps and the unsort.

Each stage runs `k` times in a chain (each call's input takes a term of
the previous output, the reference's data dependence through its scan
carry, so no call can be skipped), after a warm-up chain, timed with
``utils/profiling.seconds_per_call`` (CUDA events on the card); a line per
stage with the reference's label, milliseconds a call and the checksum of
the chain's last carry. The rebuild and the h-solve take max(2, k // 4)
calls. The state: the ``jupiter_100k`` preset's initial conditions,
primed (as the reference), or a state file with --ck (its particles; the
config is the preset's at the file's n, as the reference's). Runs on the
card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.profile_block \\
        --ck docs/results/drift100k_r5ship/state.psph --k 4
"""

from __future__ import annotations

import argparse

import torch

from .. import config as config_mod
from ..models import ics, planet
from ..ops import eos as eos_ops, structure
from ..ops.cuda import groups2 as gk2
from ..state import resolve_device
from ..utils import checkpoint
from ..utils.profiling import seconds_per_call

STAGES = ("forces", "build", "prep", "gather", "hsolve", "pass1", "pass2",
          "p2p", "unsort")


def timed(label, fn, carry, k, dev):
    """ms a call of ``fn(carry) -> carry`` over a chain of k calls, printed
    with the checksum (sum) of the chain's last carry."""
    def chain():
        c = carry
        for _ in range(k):
            c = fn(c)
        return c
    dt, c = seconds_per_call(chain, dev)
    dt /= k
    print(f"{label:34s} {dt*1e3:9.2f} ms   (checksum "
          f"{float(c.sum()):.3e})", flush=True)
    return dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--only", default=None,
                    help="comma-separated stage filter: "
                         + ", ".join(STAGES))
    ap.add_argument("--ck", default=None,
                    help="a state file: profile its operating point (the "
                         "settled state) instead of the cold ICs")
    ap.add_argument("--windows", default=None,
                    help="nbr,p2p,m2p window override")
    ap.add_argument("--xw", type=int, default=0,
                    help="sph_exact_window (particle-granularity lists)")
    ap.add_argument("--gradh", action="store_true",
                    help="the grad_h production physics config (the "
                         "preset's own)")
    ap.add_argument("--gb", type=int, default=None,
                    help="kernel_gb override (changes nothing here)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    want = set(args.only.split(",")) if args.only else None
    on = lambda name: want is None or name in want
    dev = resolve_device(args.device)

    kw = {}
    if args.windows:
        nw, pw, mw = (int(x) for x in args.windows.split(","))
        kw = dict(nbr_window=nw, p2p_window=pw, m2p_window=mw)
    if args.xw:
        kw["sph_exact_window"] = args.xw
    if args.gradh:
        kw.update(grad_p_mode="grad_h", h_mode="newton")
    if args.gb is not None:
        kw["kernel_gb"] = args.gb
    if args.ck:
        state, _, _ = checkpoint.load(args.ck, device=dev)
        cfg = config_mod.jupiter_100k(n=state.n, **kw)
    else:
        cfg = config_mod.jupiter_100k(n=args.n, **kw)
        state = planet.prime(ics.jupiter(cfg, device=dev),
                             cfg.replace(rebuild_every=1))
    config_mod.check_slice(cfg)
    pos, h, mass = state.pos, state.h, state.mass
    bsz, sub, chunk = cfg.nbr_group_size, cfg.nbr_sub, cfg.block_chunk
    print(f"n={cfg.n}  bsz={bsz}  W={cfg.nbr_window} "
          f"Wp={cfg.p2p_window}  chunk={chunk}  on {dev}", flush=True)

    st = structure.build(pos, h, mass, cfg)
    print(f"groups={st.groups.live.shape[0]} "
          f"n_sph avg={float(st.n_sph.float().mean()):.1f} "
          f"max={int(st.n_sph.max())}  "
          f"n_p2p avg={float(st.n_p2p.float().mean()):.1f} "
          f"max={int(st.n_p2p.max())}  "
          f"accept frac={float(st.accept.float().mean()):.3f}", flush=True)
    zero = torch.zeros((), device=dev)
    k, k_rebuild = args.k, max(2, args.k // 4)

    if on("forces"):
        timed("forces (full)",
              lambda c: c + 1e-9 * structure.forces(c, h, mass, cfg,
                                                    st).grad_p, pos, k, dev)
    if on("build"):
        timed("build",
              lambda c: c + 1e-12 * structure.build(c, h, mass,
                                                    cfg).accept.sum(),
              pos, k_rebuild, dev)
    if on("prep"):
        timed("prep (sorts)",
              lambda c: c + 1e-12 * structure._prep_ctx(
                  c, h, mass, cfg, st).t["x"][0], pos, k, dev)

    ctx = structure._prep_ctx(pos, h, mass, cfg, st)
    scols = structure._geom(ctx.s)          # x, y, z, ih, m
    nsub = ctx.nb * (bsz // sub)
    with_c = lambda cols, c: [cols[0] + c] + cols[1:]

    if on("gather"):
        timed("sph rows gather (geom x5)",
              lambda c: c + 1e-12 * structure._sph_rows(
                  with_c(scols, c), st, cfg, ctx.nb)[0][0, 0], zero, k, dev)
        timed("window gather (p2p geom x5)",
              lambda c: c + 1e-12 * structure._window_gather(
                  with_c(scols, c), st.p2p_idx, nsub, sub, chunk)[0][0, 0],
              zero, k, dev)
    if on("hsolve"):
        eta = planet.h_eta(cfg)
        timed("h-solve (newton, throwaway build)",
              lambda c: c + 1e-9 * structure.solve_h_newton(
                  c, h, mass, cfg, eta)[:, None], pos, k_rebuild, dev)

    geom_rows = structure._sph_rows(scols, st, cfg, ctx.nb)
    nv = structure._sph_nv(st, cfg)
    t = ctx.t
    tgt1 = structure._cols(t["x"], t["y"], t["z"], t["ih"])
    gradh = cfg.grad_p_mode == "grad_h"

    if on("pass1"):
        def p1(c):
            tg = with_c(tgt1, c)
            if gradh:
                rho = gk2.pass1_gradh(nv, tg, [geom_rows[0], geom_rows[1],
                                               geom_rows[2], geom_rows[4]],
                                      b=bsz)[0]
            else:
                rho = gk2.pass1_sym(nv, tg, geom_rows, b=bsz)[0]
            return c + 1e-12 * rho[0, 0]
        timed("pass1 kernel", p1, zero, k, dev)

    rho_t, nn_t, _ = structure._density_sweep(ctx, cfg, st, src1=geom_rows)
    prs_t = eos_ops.pressure(rho_t, cfg.eos_k, cfg.eos_gamma)
    cc = prs_t / (rho_t * rho_t)
    tgt2 = structure._cols(t["x"], t["y"], t["z"], t["ih"], cc)
    extra_rows = structure._window_gather([cc], st.sph_idx, nsub, sub, chunk)

    if on("pass2"):
        timed("pass2 kernel",
              lambda c: c + 1e-12 * gk2.pass2(
                  nv, with_c(tgt2, c), geom_rows + extra_rows, b=bsz,
                  mode="grad_h" if gradh else "symmetric", av=False,
                  sign_bug=False)[0][0, 0], zero, k, dev)
    if on("p2p"):
        receiver = cfg.softening_mode == "receiver_h"
        p2p_rows = structure._window_gather(scols, st.p2p_idx, nsub, sub,
                                            chunk)
        if receiver:
            p2p_rows = [p2p_rows[0], p2p_rows[1], p2p_rows[2], p2p_rows[4]]
        nvp = structure._i32(torch.clamp(st.n_p2p, max=cfg.p2p_window)
                             * sub)
        timed("p2p kernel",
              lambda c: c + 1e-12 * gk2.p2p(
                  nvp, with_c(tgt1, c), p2p_rows, b=bsz,
                  receiver_soft=receiver, g_const=cfg.g_const)[0][0, 0],
              zero, k, dev)
    if on("unsort"):
        timed("unsort (inverse-perm gather x3)",
              lambda c: c + 1e-12 * structure._unsort(
                  st, [rho_t + c, prs_t, nn_t])[0][0], zero, k, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
