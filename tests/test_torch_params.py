"""The port's parameter registry equals the TPU package's, field by field."""

import dataclasses

import pytest

from mosfhet_tpu import params as jparams
from mosfhet_torch import params as tparams
from tests.test_torch_suite_env import port_test_env  # noqa: F401


def test_registry_names_match():
    assert list(tparams.PARAM_REGISTRY) == list(jparams.PARAM_REGISTRY)


@pytest.mark.parametrize("name", list(jparams.PARAM_REGISTRY))
def test_param_set_fields_match(name):
    want = jparams.PARAM_REGISTRY[name]
    got = tparams.get_params(name)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    for prop in ("log_N", "log_N2", "Bg", "base"):
        assert getattr(got, prop) == getattr(want, prop), prop
