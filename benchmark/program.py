"""The system under test: ``planetmodel_sph_tpu_torch``'s set-up
(``planet.prime``) and its frame (``planet.run_info``), the way ``cli run``
and the live viewer drive it, with one host read of the frame's
diagnostics between frames.

The only module of the benchmark that imports the program; it imports it
when a :class:`Program` is made, not when this module is imported.
"""

from __future__ import annotations

import dataclasses

import torch

# the fields the comparison reads from a state
FIELDS = ("pos", "vel", "mass", "h", "rho", "n_neighbors", "grad_p",
          "grad_phi", "phi", "accel")


class Program:
    """The port, configured by a configuration file's preset and `set`;
    refuses to run unless that gives exactly the file's ``config``."""

    def __init__(self, conf: dict):
        from planetmodel_sph_tpu_torch import config as config_mod
        from planetmodel_sph_tpu_torch.models import planet
        from planetmodel_sph_tpu_torch.state import zeros
        from planetmodel_sph_tpu_torch.utils import diagnostics
        cfg = getattr(config_mod, conf["preset"])(**conf["set"])
        got = dataclasses.asdict(cfg)
        diff = sorted(k for k in set(got) | set(conf["config"])
                      if got.get(k) != conf["config"].get(k))
        if diff:
            raise ValueError(f"{conf['name']}: the preset and its `set` give "
                             f"another configuration than the file: {diff}")
        config_mod.check_slice(cfg)
        self.cfg = cfg
        self._planet, self._zeros, self._diag = planet, zeros, diagnostics

    def start(self, inputs: dict):
        """The set-up's state: the inputs, primed (one force evaluation)."""
        dev = inputs["pos"].device
        st = self._zeros(self.cfg, device=dev).replace(**inputs)
        return self._planet.prime(st, self.cfg)

    def frame(self, state, steps: int):
        """`steps` steps: (state, overflow counters on the device)."""
        return self._planet.run_info(state, self.cfg, steps)

    def read(self, state, info) -> dict:
        """The frame's diagnostics and overflow counters, read to the host
        in one copy."""
        d = self._diag.measure(state, self.cfg)
        d.update(info)
        keys = list(d)
        vals = torch.stack([d[k].to(torch.float64) for k in keys]).tolist()
        return dict(zip(keys, vals))

    @staticmethod
    def fields(state) -> dict:
        return {k: getattr(state, k) for k in FIELDS}
