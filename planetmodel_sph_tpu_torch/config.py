"""Typed simulation configuration (PyTorch port).

A framework-free copy of ``planetmodel_sph_tpu.config.SimConfig``: the same
fields and the same defaults, so a checkpoint header written by either
package configures the other, and the presets ``default``, ``auto``,
``parity``, ``basalt_impact``, ``jupiter_3k`` and ``jupiter_100k``. The
field documentation lives with the reference dataclass; the notes here only
say what the port does with each group.

The port runs the grid + tree block pipeline (every pressure form,
viscosity, the three EOS with the energy equation, fused or separate near
gravity, the supergroup far tier, sub-block windows or particle-exact SPH
lists, cached chunks sorted or not, or a rebuild per step) and the dense
all-pairs step with direct, tree or no gravity, cached or not;
:func:`check_slice` names every option outside them and refuses it loudly
instead of ignoring it.
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
    # TPU gather-row width of the exact lists' entry gathers: changes no
    # value (ops/structure._entry_gather pads as the reference does)
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


def parse_overrides(items) -> dict:
    """A list of ``K=V`` strings (a command line's ``--set``) to SimConfig
    field values."""
    out = {}
    for item in items or ():
        k, v = item.split("=", 1)
        out[k] = parse_override(k, v)
    return out


def fuse_active(cfg: SimConfig) -> bool:
    """Whether the pass-2 P2P fusion (cfg.fuse_p2p_sph) is in effect.

    The fusion rides the sub-granular SPH window rows of the grid
    pipeline's pass 2, so it is undefined for dense-SPH configs,
    particle-exact SPH lists and the supergroup far tier (whose block
    bookkeeping cannot exclude single sub-blocks); those raise."""
    if not cfg.fuse_p2p_sph:
        if cfg.fuse_p2p_residual:
            raise ValueError("fuse_p2p_residual extends fuse_p2p_sph — "
                             "enable both")
        return False
    if (cfg.neighbor_mode != "grid" or cfg.sph_exact_window > 0
            or cfg.sg_blocks > 1):
        raise ValueError(
            "fuse_p2p_sph needs the grid pipeline with sub-granular SPH "
            "windows and no supergroup tier (got neighbor_mode=%r "
            "sph_exact_window=%r sg_blocks=%r)" % (
                cfg.neighbor_mode, cfg.sph_exact_window, cfg.sg_blocks))
    return True


def _check_common(cfg: SimConfig) -> None:
    if cfg.eos_mode not in ("polytropic", "adiabatic", "tillotson"):
        raise ValueError(f"eos_mode={cfg.eos_mode!r}: 'polytropic', "
                         "'adiabatic' or 'tillotson'")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"dtype={cfg.dtype!r}: kernels are f32")


def _check_tree(cfg: SimConfig) -> None:
    """The block tree's gravity tiers (grid runs, and dense SPH with tree
    gravity)."""
    fuse_active(cfg)       # raises on a fusion the tiers cannot serve
    if cfg.grav_pair_dtype != "float32":
        raise NotImplementedError(
            f"grav_pair_dtype={cfg.grav_pair_dtype!r}: the bfloat16 pair "
            "path is a TPU tuning knob and is not ported")
    if cfg.kernel_gb != 1:
        raise ValueError(f"kernel_gb={cfg.kernel_gb}: TPU grid batching "
                         "has no meaning in the port; use 1")
    if cfg.multipole_order not in (1, 2):
        raise ValueError(f"multipole_order={cfg.multipole_order}: 1 or 2")


def _check_dense(cfg: SimConfig) -> None:
    """The dense path: all-pairs SPH with direct, tree (the ``parity``
    preset: the block tree's standalone gravity sweep) or no gravity, a
    rebuild per step or cached (the tree's structure then rebuilt every
    `rebuild_every` steps)."""
    if cfg.gravity_solver == "tree":
        _check_tree(cfg)


def _check_grid(cfg: SimConfig) -> None:
    """The grid path: the block pipeline in every pressure form, with or
    without viscosity, near gravity fused into pass 2 or swept on its own,
    sub-block windows or particle-exact SPH lists, cached chunks sorted or
    not, tree gravity or none."""
    if cfg.gravity_solver == "direct":
        raise NotImplementedError(
            "gravity_solver='direct' with neighbor_mode='grid': the block "
            "pipeline evaluates tree gravity only (the reference computes "
            "no gravity at all for this pair); use 'tree' or 'none'")
    _check_tree(cfg)


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


def auto(**kw) -> SimConfig:
    """Physically-corrected config with the pipeline picked by scale: the
    exact all-pairs path up to 32768 particles, above that
    :func:`jupiter_100k` scaled to n (same mean interparticle spacing).
    Explicit kwargs override any choice."""
    n = kw.get("n", SimConfig.n)
    if n > 32768:
        kw.setdefault("particle_radius", 5.0 * (3000 / n) ** (1.0 / 3.0))
        return jupiter_100k(**kw)
    kw.setdefault("neighbor_mode", "dense")
    kw.setdefault("gravity_solver", "direct")
    return SimConfig(**kw)


def parity(**kw) -> SimConfig:
    """Behavioral parity with the Unity project this system was modelled
    on, quirks included: asymmetric pressure gradient, receiver-h gravity
    softening, the kernel derivative sign bug, staggered Euler ordering and
    tree gravity."""
    base = dict(
        grad_p_mode="reference_asymmetric",
        softening_mode="receiver_h",
        kernel_deriv_sign_bug=True,
        integrator="staggered_euler",
        gravity_solver="tree",
        adaptive_h=True,
    )
    base.update(kw)
    return SimConfig(**base)


def basalt_impact(**kw) -> SimConfig:
    """Planetary-impact scenario in cgs units: two cold basalt bodies under
    the Tillotson EOS. Scales: two R = 50 km basalt planetesimals
    (rho0 = 2.7 g/cm^3, M ~ 1.4e21 g each), G in cgs, cold interiors
    (u0 = 1e9 erg/g << e_iv = 4.72e10). The cold basalt bulk sound speed
    sqrt(A/rho0) ~ 3.1e5 cm/s sets the CFL scale: a dt ceiling of 1 s with
    the adaptive CFL timestep. Pair with ics.two_planet_collision(
    separation ~ 2e7 cm, approach_speed ~ a few 1e5 cm/s)."""
    r_body = 5.0e6                        # 50 km in cm
    rho0 = 2.7
    m_body = 4.0 / 3.0 * 3.14159265 * r_body ** 3 * rho0
    base = dict(
        n=4096,
        eos_mode="tillotson",
        material="basalt",
        u0=1.0e9,
        g_const=6.674e-8,
        radius=r_body,
        total_mass=2.0 * m_body,          # two_planet_collision splits it
        particle_radius=r_body * (100.0 / 4096.0) ** (1.0 / 3.0),
        av_alpha=1.0,
        av_beta=2.0,
        dt_mode="cfl",
        # Tillotson is stiff (the cold bulk sound speed does not depend on
        # u): the total-energy error of a Mach-10 impact falls first-order
        # in dt; 0.1 is the reference's accuracy/cost default
        cfl_number=0.1,
        dt=1.0,                           # dt ceiling (seconds)
        dt_min=1e-4,
        h_max=r_body,                     # vacuum-halo h cap at body scale
        gravity_solver="direct",
        neighbor_mode="dense",
    )
    base.update(kw)
    return SimConfig(**base)


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
