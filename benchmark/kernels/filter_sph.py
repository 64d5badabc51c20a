"""``csrc/filter_sph.cu``: the rebuild's true-pair filter of the SPH
candidates. Its time counts among the hand kernels; its work is not
counted (a distance test a candidate, which the inputs' pairs do not
fix), so the roofline leaves it out of the least time."""

PATTERN = r"^filter_sph"


def work(cfg, n, pairs):
    return None
