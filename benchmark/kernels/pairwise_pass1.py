"""``csrc/pairwise_pass1.cu``: the all-pairs density, neighbour count and
direct gravity of the dense step (its partial-sum reduce included).

Work a step: direct gravity's N(N-1) pairs at 38 operations each, and the
pair interactions in support at the symmetric density's 38; bytes:
positions, h and mass read, rho, the count, grad phi and phi written."""

from benchmark.roofline import OPS, WORD

PATTERN = r"^pairwise_pass1"


def work(cfg, n, pairs):
    if (cfg["neighbor_mode"] != "dense" or not cfg["use_pallas"]
            or cfg["eos_mode"] != "polytropic"
            or cfg["grad_p_mode"] == "grad_h"):
        return None
    ops = pairs * OPS["pass1_sym"]
    if cfg["gravity_solver"] == "direct":
        ops += n * (n - 1) * OPS["p2p"]
    return ops, n * WORD * (5 + 6)
