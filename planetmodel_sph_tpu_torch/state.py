"""Particle state as a dataclass of tensors (PyTorch port).

Same fields, shapes and dtypes as ``planetmodel_sph_tpu.state.ParticleState``
(see its docstring for the mapping to the reference's components). Every
tensor of one state lives on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SimConfig


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Never falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class ParticleState:
    """Struct-of-arrays particle state: [N] / [N, 3] tensors."""

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    h: torch.Tensor
    rho: torch.Tensor
    pressure: torch.Tensor
    grad_p: torch.Tensor
    phi: torch.Tensor
    grad_phi: torch.Tensor
    n_neighbors: torch.Tensor
    n_direct: torch.Tensor
    n_approx: torch.Tensor
    accel: torch.Tensor
    u: torch.Tensor
    du_dt: torch.Tensor
    matid: torch.Tensor
    balsara: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(ParticleState))


def from_numpy(arrays: dict, device="cuda") -> ParticleState:
    """Build a state from a dict of numpy arrays (every field present)."""
    dev = resolve_device(device)
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    # np.array copies: arrays exported from other frameworks are read-only
    return ParticleState(**{k: torch.from_numpy(np.array(arrays[k])).to(dev)
                            for k in FIELDS})


def to_numpy(state: ParticleState) -> dict:
    """Every field as a numpy array on the host."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}


def zeros(config: SimConfig, device="cuda") -> ParticleState:
    """All-zero state with the right shapes/dtypes."""
    dev = resolve_device(device)
    n = config.n
    dt = config.torch_dtype
    v3 = lambda: torch.zeros((n, 3), dtype=dt, device=dev)
    v1 = lambda: torch.zeros((n,), dtype=dt, device=dev)
    i1 = lambda: torch.zeros((n,), dtype=torch.int32, device=dev)
    return ParticleState(
        pos=v3(), vel=v3(), mass=v1(), h=v1(), rho=v1(), pressure=v1(),
        grad_p=v3(), phi=v1(), grad_phi=v3(), n_neighbors=i1(),
        n_direct=i1(), n_approx=i1(), accel=v3(), u=v1(), du_dt=v1(),
        matid=i1(), balsara=torch.ones((n,), dtype=dt, device=dev))
