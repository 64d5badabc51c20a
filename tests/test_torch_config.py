"""The port's SimConfig and presets against the JAX package's."""

import dataclasses

import pytest

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu_torch import config as tc

PRESETS = ["default", "jupiter_3k", "jupiter_100k"]


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
], ids=["preset", "n32768", "no_gravity", "parity_flags", "gradh_newton",
        "av_balsara", "cfl_damped_frozen"])
def test_dense_preset_and_its_options_are_in_slice(kw):
    tc.check_slice(tc.jupiter_3k(**kw))
    tc.check_slice(tc.default(**kw))


@pytest.mark.parametrize("kw,word", [
    (dict(eos_mode="adiabatic"), "eos_mode"),
    (dict(eos_mode="tillotson"), "eos_mode"),
    (dict(gravity_solver="tree"), "gravity_solver"),
    (dict(rebuild_every=8), "rebuild_every"),
    (dict(dtype="bfloat16"), "dtype"),
    (dict(neighbor_mode="octree"), "neighbor_mode"),
    (dict(neighbor_mode="grid"), "neighbor_mode='grid'"),
])
def test_dense_path_refuses_unported_options_by_name(kw, word):
    with pytest.raises((NotImplementedError, ValueError), match=word):
        tc.check_slice(tc.jupiter_3k(**kw))


def test_unported_presets_stay_out():
    for name in ("auto", "parity", "basalt_impact"):
        assert not hasattr(tc, name), name


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


@pytest.mark.parametrize("kw,word", [
    (dict(av_alpha=1.0), "av_alpha"),
    (dict(eos_mode="adiabatic"), "eos_mode"),
    (dict(sph_exact_window=512), "sph_exact_window"),
    (dict(sg_blocks=4), "sg_blocks"),
    (dict(fuse_p2p_residual=False), "fuse_p2p_residual"),
    (dict(grav_pair_dtype="bfloat16"), "grav_pair_dtype"),
    (dict(kernel_gb=8), "kernel_gb"),
    (dict(neighbor_mode="dense"), "neighbor_mode"),
    (dict(kernel_deriv_sign_bug=True), "kernel_deriv_sign_bug"),
    (dict(gravity_solver="direct"), "gravity_solver"),
    (dict(softening_mode="receiver_h"), "softening_mode"),
])
def test_out_of_slice_options_refused_by_name(kw, word):
    with pytest.raises((NotImplementedError, ValueError), match=word):
        tc.check_slice(tc.jupiter_100k(**kw))
