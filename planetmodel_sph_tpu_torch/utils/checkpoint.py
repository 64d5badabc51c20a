"""Checkpoint helpers (PyTorch port).

Only the back-fill of fields that older checkpoints lack is ported; the
PSPH1 reader and writer are in ``runtime/snapshot.py``.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops import eos as eos_ops
from ..state import ParticleState


def _fill_missing(fields: dict, cfg: SimConfig) -> ParticleState:
    """Back-fill state fields absent from older checkpoints: u from the
    polytropic relation at the stored density, du_dt zero, matid the
    config's material, balsara one."""
    rho = fields["rho"]
    if "u" not in fields:
        fields["u"] = eos_ops.internal_energy(rho, cfg.eos_k, cfg.eos_gamma)
    if "du_dt" not in fields:
        fields["du_dt"] = torch.zeros_like(rho)
    if "matid" not in fields:
        fields["matid"] = torch.full(rho.shape,
                                     eos_ops.material_index(cfg.material),
                                     dtype=torch.int32, device=rho.device)
    if "balsara" not in fields:
        fields["balsara"] = torch.ones_like(rho)
    return ParticleState(**fields)
