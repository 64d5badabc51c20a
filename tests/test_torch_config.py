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


@pytest.mark.parametrize("kw,word", [
    (dict(av_alpha=1.0), "av_alpha"),
    (dict(eos_mode="adiabatic"), "eos_mode"),
    (dict(sph_exact_window=512), "sph_exact_window"),
    (dict(sg_blocks=4), "sg_blocks"),
    (dict(fuse_p2p_residual=False), "fuse_p2p_residual"),
    (dict(grav_pair_dtype="bfloat16"), "grav_pair_dtype"),
    (dict(kernel_gb=8), "kernel_gb"),
    (dict(neighbor_mode="dense"), "neighbor_mode"),
])
def test_out_of_slice_options_refused_by_name(kw, word):
    with pytest.raises((NotImplementedError, ValueError), match=word):
        tc.check_slice(tc.jupiter_100k(**kw))
