"""``csrc/pairwise_pass2.cu``: the all-pairs pressure force of the dense
step (its partial-sum reduce included).

Work a step: the pair interactions in support at 40 operations each;
bytes: positions, h, mass, rho and pressure read, grad P written."""

from benchmark.roofline import OPS, WORD

PATTERN = r"^pairwise_pass2"


def work(cfg, n, pairs):
    if (cfg["neighbor_mode"] != "dense" or not cfg["use_pallas"]
            or cfg["eos_mode"] != "polytropic"
            or cfg["grad_p_mode"] == "grad_h"):
        return None
    return pairs * OPS["pass2"], n * WORD * (7 + 3)
