"""Typed simulation configuration (PyTorch port).

A framework-free copy of ``planetmodel_sph_tpu.config.SimConfig``: the same
fields and the same defaults, so a checkpoint header written by either
package configures the other, and the presets ``default``, ``jupiter_3k``
and ``jupiter_100k``. The field documentation lives with the reference
dataclass; the notes here only say what the port does with each group.

The port runs two paths of the reference today: the cached grid + tree
RESPA chunk of ``jupiter_100k`` and the uncached dense all-pairs step of
``jupiter_3k``; :func:`check_slice` names every option outside them and
refuses it loudly instead of ignoring it.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (Python scalars and strings only)."""

    # ---- scenario / initial conditions ----
    n: int = 3000
    radius: float = 50.0
    total_mass: float = 100.0
    particle_radius: float = 5.0
    seed: int = 0

    # ---- kernel ----
    kappa: float = 2.0
    kernel_deriv_sign_bug: bool = False

    # ---- EOS ----
    eos_k: float = 1000.0
    eos_gamma: float = 2.0
    eos_mode: Literal["polytropic", "adiabatic", "tillotson"] = "polytropic"
    material: str = "basalt"
    u0: float = 0.0

    @property
    def evolves_u(self) -> bool:
        """Whether the EOS evolves the specific internal energy."""
        return self.eos_mode in ("adiabatic", "tillotson")

    # ---- pressure force ----
    grad_p_mode: Literal["reference_asymmetric", "symmetric",
                         "grad_h"] = "symmetric"

    # ---- gravity ----
    g_const: float = 1.0
    theta: float = 0.7
    gravity_solver: Literal["direct", "tree", "none"] = "direct"
    softening_mode: Literal["receiver_h", "symmetric_max"] = "symmetric_max"

    # ---- adaptive smoothing length ----
    adaptive_h: bool = True
    target_neighbors: float = 50.0
    h_mode: Literal["relax", "newton"] = "relax"
    h_max: float = 0.0
    h_newton_iters: int = 3
    h_newton_clamp: float = 0.3

    # ---- neighbor search / block structure ----
    neighbor_mode: Literal["dense", "grid"] = "dense"
    nbr_group_size: int = 64
    nbr_sub: int = 16
    nbr_window: int = 192
    sph_exact_window: int = 0
    sph_refine_subblock: bool = False
    sph_refined_window: int = 0
    h_solve_window: int = 0
    nbr_group_level: int = 4
    p2p_window: int = 256
    m2p_window: int = 256
    # lane-tile width of the TPU sweeps; the port keeps it only as the
    # padding quantum of window rows so shapes match the reference
    block_chunk: int = 512
    sg_blocks: int = 0
    blk_window: int = 192
    multipole_order: int = 1
    grav_com_correction: bool = False
    fuse_p2p_sph: bool = False
    fuse_p2p_residual: bool = False
    # TPU gather-row padding: changes no value, so the port ignores it
    gather_pad_rows: int = 0
    # TPU grid batching: the port has one launch layout and refuses != 1
    kernel_gb: int = 1

    # ---- integration ----
    dt: float = 0.02
    dt_mode: Literal["fixed", "cfl"] = "fixed"
    cfl_number: float = 0.25
    dt_min: float = 1e-5
    integrator: Literal["staggered_euler", "leapfrog_kdk"] = "leapfrog_kdk"

    # ---- interaction-list caching ----
    rebuild_every: int = 1
    skin_safety: float = 2.0
    sort_every: int = 0
    sorted_chunks: bool = True

    # ---- velocity damping ----
    vel_damping: float = 0.0

    # ---- artificial viscosity ----
    av_alpha: float = 0.0
    av_beta: float = 0.0
    av_balsara: bool = False

    # ---- per-step h tracking / RESPA ----
    h_track_margin: float = 0.0
    respa_every: int = 1

    # ---- data-parallel layout ----
    dp_mode: Literal["replicated", "halo"] = "replicated"
    halo_ring_radius: int = 1
    halo_chunk: int = 64

    # ---- debug toggles ----
    freeze_velocity: bool = False

    # ---- numerics ----
    dtype: str = "float32"
    grav_pair_dtype: Literal["float32", "bfloat16"] = "float32"

    # ---- execution ----
    use_pallas: bool = True
    block_n: int = 512

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def particle_mass(self) -> float:
        return self.total_mass / self.n

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def from_dict(d: dict) -> SimConfig:
    """SimConfig from a serialized dict, keeping only the fields this
    version knows (checkpoints from other engine versions stay loadable)."""
    known = {f.name for f in dataclasses.fields(SimConfig)}
    return SimConfig(**{k: v for k, v in d.items() if k in known})


def parse_override(key: str, value: str):
    """Coerce a CLI ``k=v`` override to the SimConfig field's type.

    `type(default)(v)` is wrong for bools (bool('0') is True); tools that
    accept overrides must route through this."""
    fld = type(getattr(SimConfig(), key))
    if fld is bool:
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"bad bool for {key}: {value!r}")
    return fld(value)


def _check_common(cfg: SimConfig) -> None:
    if cfg.eos_mode != "polytropic":
        raise NotImplementedError(
            f"eos_mode={cfg.eos_mode!r}: the port runs the polytropic EOS "
            "only")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"dtype={cfg.dtype!r}: kernels are f32")


def _check_dense(cfg: SimConfig) -> None:
    """The dense path: all-pairs SPH with direct (or no) gravity, rebuilt
    every step (the ``jupiter_3k`` step and its options)."""
    if cfg.gravity_solver == "tree":
        raise NotImplementedError(
            "gravity_solver='tree' with neighbor_mode='dense': the block "
            "tree's standalone gravity sweep is not ported; use 'direct' or "
            "'none'")
    if cfg.rebuild_every > 1:
        raise NotImplementedError(
            f"rebuild_every={cfg.rebuild_every} with neighbor_mode='dense': "
            "the cached dense step is not ported; use rebuild_every=1")


def _check_grid(cfg: SimConfig) -> None:
    """The grid path: the cached grid + tree pipeline with grad-h SPH, the
    fused residual-P2P pass 2 and the dense block far scan (the
    ``jupiter_100k`` production step)."""
    if cfg.gravity_solver != "tree":
        raise NotImplementedError(
            f"gravity_solver={cfg.gravity_solver!r} with neighbor_mode="
            "'grid': the port's grid pipeline runs tree gravity only")
    if cfg.grad_p_mode != "grad_h":
        raise NotImplementedError(
            f"grad_p_mode={cfg.grad_p_mode!r} with neighbor_mode='grid': "
            "the port's grid pipeline runs grad_h only")
    if cfg.av_alpha > 0.0:
        raise NotImplementedError("av_alpha>0 with neighbor_mode='grid': "
                                  "artificial viscosity is ported on the "
                                  "dense path only")
    if cfg.kernel_deriv_sign_bug:
        raise NotImplementedError("kernel_deriv_sign_bug with neighbor_mode="
                                  "'grid': ported on the dense path only")
    if cfg.sph_exact_window > 0:
        raise NotImplementedError("sph_exact_window>0: particle-exact SPH "
                                  "lists are not ported")
    if cfg.sg_blocks > 1:
        raise NotImplementedError("sg_blocks>1: the supergroup far tier is "
                                  "not ported")
    if not (cfg.fuse_p2p_sph and cfg.fuse_p2p_residual):
        raise NotImplementedError(
            "fuse_p2p_residual=False: the port sweeps near gravity only "
            "inside the merged pass 2 (needs fuse_p2p_sph and "
            "fuse_p2p_residual)")
    if cfg.softening_mode != "symmetric_max":
        raise NotImplementedError(
            f"softening_mode={cfg.softening_mode!r} with neighbor_mode="
            "'grid': the port's grid pipeline runs symmetric_max only")
    if cfg.grav_pair_dtype != "float32":
        raise NotImplementedError(
            f"grav_pair_dtype={cfg.grav_pair_dtype!r}: the bfloat16 pair "
            "path is a TPU tuning knob and is not ported")
    if cfg.kernel_gb != 1:
        raise ValueError(f"kernel_gb={cfg.kernel_gb}: TPU grid batching "
                         "has no meaning in the port; use 1")
    if cfg.multipole_order not in (1, 2):
        raise ValueError(f"multipole_order={cfg.multipole_order}: 1 or 2")


def check_slice(cfg: SimConfig) -> None:
    """Refuse, by name, every option the port does not run yet. Two paths
    are admitted, selected by `neighbor_mode`: 'dense' and 'grid'."""
    _check_common(cfg)
    if cfg.neighbor_mode == "dense":
        _check_dense(cfg)
    elif cfg.neighbor_mode == "grid":
        _check_grid(cfg)
    else:
        raise ValueError(f"neighbor_mode={cfg.neighbor_mode!r}: 'dense' or "
                         "'grid'")


def default(**kw) -> SimConfig:
    """Recommended physically-corrected configuration."""
    return SimConfig(**kw)


def jupiter_3k(**kw) -> SimConfig:
    """BASELINE.json config "Jupiter v1": 3k particles, corrected physics."""
    base = dict(n=3000, gravity_solver="direct", neighbor_mode="dense")
    base.update(kw)
    return SimConfig(**base)


def jupiter_100k(**kw) -> SimConfig:
    """North-star config: 100k particles, grid neighbors + tree gravity,
    with the production stack (grad-h + Newton h, tracked h, sub-block
    refine and truncation, K=32 chunks, RESPA far field once per chunk,
    quadrupole far field, fused residual P2P). The rationale for each
    value is in the reference preset."""
    base = dict(
        n=100_000,
        gravity_solver="tree",
        neighbor_mode="grid",
        grad_p_mode="grad_h",
        h_mode="newton",
        nbr_sub=32,
        rebuild_every=32,
        sort_every=64,
        multipole_order=2,
        theta=1.0,
        grav_com_correction=True,
        gather_pad_rows=32,
        h_track_margin=0.04,
        sph_refine_subblock=True,
        sph_refined_window=80,
        respa_every=32,
        fuse_p2p_sph=True,
        fuse_p2p_residual=True,
        nbr_window=240,
        p2p_window=112,
        m2p_window=128,
        radius=50.0,
        particle_radius=5.0 * (3000 / 100_000) ** (1.0 / 3.0),
    )
    base.update(kw)
    return SimConfig(**base)
