"""``csrc/gravity_fused.cu``: the tree's far tier (the quadrupole ring and
the far scan), once a RESPA period on the production step.

Work a step: m2p_window far entries for every particle, a monopole (12
operations) plus the quadrupole's 28 under multipole_order 2, over the
RESPA period. Bytes: positions and mass read, grad phi and phi written."""

from benchmark.roofline import OPS, WORD

PATTERN = r"^gravity_fused_kernel"


def work(cfg, n, pairs):
    if cfg["neighbor_mode"] != "grid" or cfg["gravity_solver"] != "tree":
        return None
    per = OPS["mono"] + (OPS["quad_extra"] if cfg["multipole_order"] >= 2
                         else 0)
    period = max(1, cfg["respa_every"])
    return (n * cfg["m2p_window"] * per / period,
            n * WORD * (4 + 4) / period)
