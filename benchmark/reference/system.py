"""The reference put in the program's place: the same set-up and frames,
computed by a configuration's plain reference in a dtype of the caller's
choice. In a lower precision than the configuration states it is the
control the comparison has to refuse."""

from __future__ import annotations

import torch

FIELDS = ("pos", "vel", "mass", "h", "rho", "n_neighbors", "grad_p",
          "grad_phi", "phi", "accel")


class ReferenceSystem:
    def __init__(self, conf: dict, module, dtype: torch.dtype):
        self.cfg = conf["config"]
        self.module = module
        self.dtype = dtype

    def start(self, inputs: dict) -> dict:
        return self.module.start(
            {k: v.to(self.dtype) for k, v in inputs.items()}, self.cfg)

    def frame(self, state: dict, steps: int):
        zero = torch.zeros((), dtype=torch.int32, device=state["pos"].device)
        return (self.module.frame(state, self.cfg, steps),
                {"nbr_overflow": zero, "tree_overflow": zero})

    def read(self, state: dict, info: dict) -> dict:
        m, v = state["mass"], state["vel"]
        vals = torch.stack([
            (0.5 * m * (v * v).sum(dim=-1)).sum().double(),
            (0.5 * m * state["phi"]).sum().double(),
            info["nbr_overflow"].double(), info["tree_overflow"].double()])
        keys = ("kinetic_energy", "potential_energy", "nbr_overflow",
                "tree_overflow")
        out = dict(zip(keys, vals.tolist()))
        out["total_energy"] = out["kinetic_energy"] + out["potential_energy"]
        return out

    @staticmethod
    def fields(state: dict) -> dict:
        return {k: state[k] for k in FIELDS}
