"""Checkpoint save/restore (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/utils/checkpoint.py``: the full
ParticleState, the SimConfig and the step counter in one file, npz or
PSPH1 (``runtime/snapshot.py``, chosen by a ``.psph`` suffix on save and by
the file's magic on load). An npz holds one array per state field,
``__config__`` (the config as JSON bytes) and ``__step__``, so files
written by either package load in the other. ``.psph`` files go through
the port's copy of the reference's native writer (C++, built with g++ at
first use; a background thread streams each frame with its CRC), and where
it cannot be built numpy writes the same bytes.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .. import config as config_mod
from ..config import SimConfig
from ..ops import eos as eos_ops
from ..state import ParticleState, resolve_device, to_numpy
from . import profiling


@profiling.spanned(profiling.CHECKPOINT)
def save(path: str, state: ParticleState, cfg: SimConfig,
         step: int = 0) -> None:
    """Save a checkpoint: PSPH1 for a ``.psph`` path, else npz at exactly
    `path`."""
    if path.endswith(".psph"):
        from ..runtime import snapshot
        snapshot.save(path, state, cfg, step)
        return
    # write through a file object: np.savez(path) appends '.npz' to paths
    # lacking the suffix
    with open(path, "wb") as f:
        np.savez(
            f,
            __config__=np.frombuffer(
                json.dumps(dataclasses.asdict(cfg)).encode(), dtype=np.uint8),
            __step__=np.asarray(step, np.int64),
            **to_numpy(state))


def load(path: str, device="cuda"):
    """Returns (state, cfg, step) with the state on `device`; PSPH1 or npz
    by the file's magic. Config keys this version does not know are
    dropped, state fields the file lacks are back-filled."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(5)
    if magic == b"PSPH1":
        from ..runtime import snapshot
        return snapshot.load(path, device=dev)
    known = {f.name for f in dataclasses.fields(ParticleState)}
    with np.load(path) as z:
        cfg = config_mod.from_dict(json.loads(bytes(z["__config__"])))
        step = int(z["__step__"])
        fields = {k: torch.from_numpy(np.array(z[k])).to(dev)
                  for k in z.files if k in known}
    return _fill_missing(fields, cfg), cfg, step


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
