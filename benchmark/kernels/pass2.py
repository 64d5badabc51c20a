"""``csrc/pass2.cu``: the windowed pressure force, with the near gravity of
the SPH rows and of the residual-P2P window fused in.

Work a step: the pair interactions in support at 40 operations each; with
the near gravity fused, the configured near tier too: p2p_window sub-blocks
of nbr_sub sources for every particle, at 38 operations a pair. Bytes: the
targets' and sources' fields read once (positions, h, mass, rho, Omega or
the pressure coefficient), grad P, grad phi, phi and the count written."""

from benchmark.roofline import OPS, WORD

PATTERN = r"^pass2_kernel"


def work(cfg, n, pairs):
    if cfg["neighbor_mode"] != "grid":
        return None
    ops = pairs * OPS["pass2"]
    if cfg["gravity_solver"] == "tree" and cfg["fuse_p2p_sph"]:
        ops += n * cfg["p2p_window"] * cfg["nbr_sub"] * OPS["p2p"]
    return ops, n * WORD * (8 + 8)
