"""``csrc/pass1_gradh.cu``: the windowed grad-h density sweep (rho, Omega,
the neighbour count), every step and in each sweep of the Newton h-solve
at a rebuild.

Work a step: the pair interactions in support (the reference's neighbour
count) at 26 operations each, once for the step's sweep and once for each
warm-started sweep of the solve, spread over the rebuild period; bytes:
positions, h and mass read, rho, Omega and the count written, once a
sweep."""

from benchmark.roofline import OPS, WORD

PATTERN = r"^pass1_gradh_kernel"


def work(cfg, n, pairs):
    if cfg["neighbor_mode"] != "grid" or cfg["grad_p_mode"] != "grad_h":
        return None
    sweeps = 1.0
    if cfg["adaptive_h"] and cfg["h_mode"] == "newton":
        sweeps += (max(1, cfg["h_newton_iters"] - 1)
                   / max(1, cfg["rebuild_every"]))
    return (sweeps * pairs * OPS["pass1_gradh"],
            sweeps * n * WORD * (5 + 3))
