"""``csrc/pass1_sym.cu``: the windowed symmetric density sweep.

Work a step: the pair interactions in support at 38 operations each;
bytes: positions, h and mass read, rho and the count written."""

from benchmark.roofline import OPS, WORD

PATTERN = r"^pass1_sym_kernel"


def work(cfg, n, pairs):
    if cfg["neighbor_mode"] != "grid" or cfg["grad_p_mode"] == "grad_h":
        return None
    return pairs * OPS["pass1_sym"], n * WORD * (5 + 2)
