"""The yardstick of the roofline metrics: operations a pair interaction
and the least time of a count of work on a card's published peaks.

``OPS`` counts the float32 operations of one pair slot of each sweep
(where/select/compare one operation, accumulator adds included): pass 1
symmetric evaluates W at both h (38), grad-h one W and dW/dh (26); pass 2
the pressure force (40); a softened P2P pair (38); a monopole (12) and
the quadrupole's extra terms (28). They are the program's own roofline
tool's counts (``planetmodel_sph_tpu_torch/tools/roofline.py``), kept here
so that the count cannot move with the program.
"""

from __future__ import annotations

OPS = {"pass1_sym": 38, "pass1_gradh": 26, "pass2": 40, "p2p": 38,
       "mono": 12, "quad_extra": 28}

# bytes of one float32 or int32 value
WORD = 4


def least_time(ops: float, nbytes: float, peaks: dict) -> float:
    """Seconds the card needs at least: the larger of the operations at
    its float32 rate and the bytes at its memory rate."""
    return max(ops / peaks["flops"], nbytes / peaks["bytes_per_s"])
