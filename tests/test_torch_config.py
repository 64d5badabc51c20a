"""The port's SimConfig and presets against the JAX package's."""

import dataclasses

import pytest

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu_torch import config as tc

PRESETS = ["default", "auto", "parity", "jupiter_3k", "jupiter_100k"]


def test_every_field_and_default_matches():
    ref = [(f.name, f.default) for f in dataclasses.fields(jc.SimConfig)]
    out = [(f.name, f.default) for f in dataclasses.fields(tc.SimConfig)]
    assert out == ref


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches(name):
    ref = dataclasses.asdict(getattr(jc, name)())
    out = dataclasses.asdict(getattr(tc, name)())
    assert out == ref


def test_properties_and_from_dict():
    cfg = tc.jupiter_100k()
    assert cfg.particle_mass == jc.jupiter_100k().particle_mass
    assert cfg.evolves_u is False and cfg.torch_dtype.is_floating_point
    d = dataclasses.asdict(jc.jupiter_100k())
    d["tree_levels"] = 7            # a field of another engine version
    assert tc.from_dict(d) == cfg


def test_production_preset_is_in_slice():
    tc.check_slice(tc.jupiter_100k())


@pytest.mark.parametrize("kw", [
    {}, dict(n=32768), dict(gravity_solver="none"),
    dict(grad_p_mode="reference_asymmetric", kernel_deriv_sign_bug=True,
         softening_mode="receiver_h", integrator="staggered_euler"),
    dict(grad_p_mode="grad_h", h_mode="newton"),
    dict(av_alpha=1.0, av_beta=2.0, av_balsara=True),
    dict(dt_mode="cfl", vel_damping=0.1, freeze_velocity=True),
    dict(gravity_solver="tree", softening_mode="receiver_h"),
    dict(gravity_solver="tree", multipole_order=2, grad_p_mode="grad_h",
         grav_com_correction=True),
], ids=["preset", "n32768", "no_gravity", "parity_flags", "gradh_newton",
        "av_balsara", "cfl_damped_frozen", "tree_gravity",
        "tree_gravity_gradh_quadrupole"])
def test_dense_preset_and_its_options_are_in_slice(kw):
    tc.check_slice(tc.jupiter_3k(**kw))
    tc.check_slice(tc.default(**kw))


@pytest.mark.parametrize("kw,word", [
    (dict(eos_mode="isothermal"), "eos_mode"),
    (dict(eos_mode="ideal_gas"), "eos_mode"),
    (dict(gravity_solver="tree", sg_blocks=4, fuse_p2p_sph=True),
     "sg_blocks"),
    (dict(gravity_solver="tree", grav_pair_dtype="bfloat16"),
     "grav_pair_dtype"),
    (dict(gravity_solver="tree", kernel_gb=8), "kernel_gb"),
    (dict(gravity_solver="tree", multipole_order=3), "multipole_order"),
    (dict(dtype="bfloat16"), "dtype"),
    (dict(neighbor_mode="octree"), "neighbor_mode"),
    (dict(neighbor_mode="grid"), "neighbor_mode='grid'"),
])
def test_dense_path_refuses_unported_options_by_name(kw, word):
    with pytest.raises((NotImplementedError, ValueError), match=word):
        tc.check_slice(tc.jupiter_3k(**kw))


def test_unported_presets_stay_out():
    """Every preset of the reference is ported and in the slice."""
    for name in ("default", "auto", "parity", "basalt_impact", "jupiter_3k",
                 "jupiter_100k"):
        assert hasattr(jc, name) and hasattr(tc, name), name
    tc.check_slice(tc.basalt_impact())
    tc.check_slice(tc.parity())
    tc.check_slice(tc.auto())
    tc.check_slice(tc.auto(n=50_000))


@pytest.mark.parametrize("n", [3000, 32768, 32769, 100_000])
def test_auto_matches_jax_at_every_scale(n):
    assert dataclasses.asdict(tc.auto(n=n)) == dataclasses.asdict(
        jc.auto(n=n))
    assert tc.auto(n=n, theta=0.5).theta == 0.5


@pytest.mark.parametrize("kw", [
    dict(grad_p_mode="symmetric", h_mode="relax"),
    dict(grad_p_mode="reference_asymmetric", kernel_deriv_sign_bug=True),
    dict(av_alpha=1.0, av_beta=2.0),
    dict(av_alpha=0.5, av_beta=1.0, av_balsara=True, vel_damping=0.1),
    dict(softening_mode="receiver_h"),
    dict(fuse_p2p_residual=False),
    dict(fuse_p2p_sph=False, fuse_p2p_residual=False),
    dict(gravity_solver="none", fuse_p2p_sph=False,
         fuse_p2p_residual=False),
    dict(rebuild_every=1, respa_every=1),
    dict(integrator="staggered_euler", respa_every=1),
    dict(multipole_order=1, sph_refine_subblock=False,
         sph_refined_window=0),
], ids=["symmetric_relax", "asymmetric_sign_bug", "av", "av_balsara_damped",
        "receiver_h", "fused_unmerged", "unfused", "no_gravity", "uncached",
        "staggered", "monopole_unrefined"])
def test_grid_options_this_slice_admits(kw):
    tc.check_slice(tc.jupiter_100k(**kw))


@pytest.mark.parametrize("key,value,expect", [
    ("theta", "0.9", 0.9), ("multipole_order", "2", 2),
    ("softening_mode", "receiver_h", "receiver_h"),
    ("av_balsara", "true", True), ("adaptive_h", "0", False),
    ("kernel_deriv_sign_bug", "On", True),
])
def test_parse_override_matches_jax(key, value, expect):
    out = tc.parse_override(key, value)
    assert out == expect == jc.parse_override(key, value)
    assert type(out) is type(expect)


def test_parse_override_refuses_a_bad_bool():
    with pytest.raises(ValueError, match="av_balsara"):
        tc.parse_override("av_balsara", "maybe")


def test_parse_overrides_reads_a_set_list():
    """The ``--set`` list of the command lines: each K=V by its field's
    type, a later item wins, no list is no override."""
    out = tc.parse_overrides(["p2p_window=256", "fuse_p2p_sph=false",
                              "grad_p_mode=symmetric", "p2p_window=288"])
    assert out == dict(p2p_window=288, fuse_p2p_sph=False,
                       grad_p_mode="symmetric")
    assert tc.parse_overrides(None) == {}


@pytest.mark.parametrize("kw,word", [
    (dict(eos_mode="isothermal"), "eos_mode"),
    (dict(eos_mode="ideal_gas"), "eos_mode"),
    (dict(sph_exact_window=512), "sph_exact_window"),
    (dict(sg_blocks=4), "sg_blocks"),
    (dict(grav_pair_dtype="bfloat16"), "grav_pair_dtype"),
    (dict(kernel_gb=8), "kernel_gb"),
    (dict(neighbor_mode="dense"), "fuse_p2p_sph"),
    (dict(gravity_solver="direct"), "gravity_solver='direct'"),
    (dict(sorted_chunks=False, sg_blocks=4), "sg_blocks"),
    (dict(dtype="float64"), "dtype"),
    (dict(multipole_order=3), "multipole_order"),
])
def test_out_of_slice_options_refused_by_name(kw, word):
    with pytest.raises((NotImplementedError, ValueError), match=word):
        tc.check_slice(tc.jupiter_100k(**kw))


@pytest.mark.parametrize("kw", [
    dict(eos_mode="adiabatic"), dict(eos_mode="tillotson"),
    dict(eos_mode="adiabatic", av_alpha=1.0, av_beta=2.0),
    dict(eos_mode="tillotson", material="ice", u0=1e9),
], ids=["adiabatic", "tillotson", "adiabatic_av", "tillotson_ice"])
def test_evolved_u_eos_is_in_slice_on_both_neighbour_modes(kw):
    tc.check_slice(tc.jupiter_3k(**kw))
    tc.check_slice(tc.jupiter_3k(grad_p_mode="grad_h", **kw))
    tc.check_slice(tc.jupiter_100k(**kw))
    tc.check_slice(tc.jupiter_100k(grad_p_mode="symmetric", h_mode="relax",
                                   fuse_p2p_sph=False,
                                   fuse_p2p_residual=False, **kw))
    assert tc.SimConfig(**kw).evolves_u


@pytest.mark.parametrize("kw", [
    dict(sg_blocks=4, blk_window=768), dict(sg_blocks=2),
    dict(sg_blocks=4, multipole_order=1, eos_mode="adiabatic"),
], ids=["sg4", "sg2", "sg4_monopole_adiabatic"])
def test_supergroup_tier_is_in_slice_without_the_fusion(kw):
    unfused = dict(fuse_p2p_sph=False, fuse_p2p_residual=False)
    tc.check_slice(tc.jupiter_100k(**unfused, **kw))
    tc.check_slice(tc.parity(**kw))
    # fused near gravity cannot exclude single sub-blocks from a supergroup
    with pytest.raises(ValueError, match="no supergroup tier"):
        tc.check_slice(tc.jupiter_100k(**kw))


def test_basalt_impact_preset_equals_jax_field_by_field():
    for kw in ({}, dict(n=512), dict(neighbor_mode="grid",
                                     gravity_solver="tree", cfl_number=0.05)):
        assert dataclasses.asdict(tc.basalt_impact(**kw)) == \
            dataclasses.asdict(jc.basalt_impact(**kw))
    cfg = tc.basalt_impact()
    assert cfg.eos_mode == "tillotson" and cfg.evolves_u
    assert cfg.dt_mode == "cfl" and cfg.n == 4096


def _names_bound_by_init(pkg):
    """The names a package's __init__.py binds itself (its imports and
    assignments), not the submodules other imports attach to it."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(pkg))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def test_top_level_binds_every_name_the_reference_binds():
    import planetmodel_sph_tpu as jp
    import planetmodel_sph_tpu_torch as tp
    names = _names_bound_by_init(jp)
    assert {"auto", "basalt_impact", "parity", "SimConfig"} <= names
    missing = sorted(n for n in names if not hasattr(tp, n))
    assert not missing, f"the port's top level lacks {missing}"


@pytest.mark.parametrize("name", ["auto", "basalt_impact", "parity",
                                  "default", "jupiter_3k", "jupiter_100k"])
def test_top_level_preset_equals_the_reference_field_by_field(name):
    import planetmodel_sph_tpu as jp
    import planetmodel_sph_tpu_torch as tp
    assert getattr(tp, name) is getattr(tc, name)
    assert dataclasses.asdict(getattr(tp, name)()) == \
        dataclasses.asdict(getattr(jp, name)())
