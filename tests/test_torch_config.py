"""The port's EnvParams and config loader against the JAX package's.

Every shipped ``configs/*.json`` must load to the same field values and the
same derived sizes in both packages, and ``validate()`` must refuse the same
configurations with the same messages.
"""

import dataclasses

import pytest

from placement_tpu.env import types as jax_types
from placement_tpu.utils import config as jax_config
from placement_tpu_torch.env import types as torch_types
from placement_tpu_torch.utils import config as torch_config

DERIVED = ("area", "num_orientations", "max_components",
           "max_num_pins_per_component", "max_pins", "max_segments_per_net",
           "has_pins", "max_wirelength", "max_num_intersections",
           "intersections_normalizer", "wirelength_normalizer")


def test_model_types_match():
    assert torch_config.MODEL_TYPES == jax_config.MODEL_TYPES
    assert torch_config.CONFIG_DIR == jax_config.CONFIG_DIR
    assert ({k: int(v) for k, v in torch_config._VARIANTS.items()}
            == {k: int(v) for k, v in jax_config._VARIANTS.items()})


@pytest.mark.parametrize("model_type", sorted(jax_config.MODEL_TYPES))
def test_env_params_match_field_for_field(model_type):
    want, _, _ = jax_config.load_experiment(model_type)
    got = torch_config.load_env_params(model_type)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "variant":
            assert (a.name, int(a)) == (b.name, int(b))
        else:
            assert a == b and type(a) is type(b), f.name
    for name in DERIVED:
        # the derived sizes are the same Python float/int expressions
        assert getattr(got, name) == getattr(want, name), name


BAD = [
    dict(height=0),
    dict(variant=0, component_n=11),
    dict(max_component_w=11),
    dict(min_component_h=0),
    dict(max_num_components=0),
    dict(max_num_components=101, min_num_components=1),
    dict(min_num_pins_per_net=7),
    dict(min_num_pins_per_net=1),
    dict(min_num_pins_per_net=6, min_num_nets=3, min_num_components=1),
    dict(reward_beam_width=0),
    dict(reward_type="shortest"),
]


@pytest.mark.parametrize("overrides", BAD)
def test_validate_raises_the_same_errors(overrides):
    def make(types):
        kw = dict(overrides)
        if "variant" in kw:
            kw["variant"] = types.Variant(kw["variant"])
        return types.EnvParams(**kw)

    with pytest.raises(ValueError) as want:
        make(jax_types).validate()
    with pytest.raises(ValueError) as got:
        make(torch_types).validate()
    assert str(got.value) == str(want.value)


def test_validate_accepts_and_replace_matches():
    base = torch_config.load_env_params("rectangle_pin")
    assert base.validate() is base
    assert base.replace(width=12).width == 12
    assert base.replace(width=12) == dataclasses.replace(base, width=12)
