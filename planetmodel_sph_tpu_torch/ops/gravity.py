"""Gravity helpers (PyTorch port): the multipole acceptance criterion.

The per-pair Dyer-Ip and multipole terms live inside the kernels of
``ops/cuda/groups2.py`` and their plain versions.
"""

from __future__ import annotations


def accept_bmax(r2, bmax2, theta: float):
    """Salmon & Warren (1993) bmax MAC (``GravityFieldSystem.cs:229-247``):
    accept a node when bmax^2 < theta^2 r^2 (squared lengths, no sqrt)."""
    return bmax2 < (theta * theta) * r2
