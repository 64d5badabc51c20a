"""``csrc/p2p.cu``: the standalone near-gravity sweep of the tree, where
the near tier is not fused into pass 2.

Work a step: p2p_window sub-blocks of nbr_sub sources for every particle
at 38 operations a pair; bytes: positions, h and mass read, grad phi, phi
and the count written."""

from benchmark.roofline import OPS, WORD

PATTERN = r"^p2p_kernel"


def work(cfg, n, pairs):
    if (cfg["neighbor_mode"] != "grid" or cfg["gravity_solver"] != "tree"
            or cfg["fuse_p2p_sph"]):
        return None
    return (n * cfg["p2p_window"] * cfg["nbr_sub"] * OPS["p2p"],
            n * WORD * (5 + 5))
