"""Name parity of what the port has of ``indicators.atmos`` and
``indicators.convert``: the same public names as the JAX package's
modules, and for each indicator the same registry key, registry id and
``identifier``. The only names allowed to be missing are those that wait
for ``indices/fire/``: the six fire-weather indicators, their six module
aliases and ``fire_season``. That list shrinks to nothing with the fire
slice."""

import pytest

import xclim_tpu.indicators.atmos as jatmos
import xclim_tpu.indicators.convert as jconvert
from xclim_tpu.core.indicator import Indicator as JIndicator
from xclim_tpu_torch.core.indicator import Indicator
from xclim_tpu_torch.indicators import atmos, convert

#: waits for indices/fire/ (xclim_tpu/indicators/atmos/_precip.py:344-416,
#: _temperature.py:1140, atmos/__init__.py:42-56)
WAITS_FOR_FIRE = {
    "cffwis", "dc", "dmc", "kbdi", "df", "ffdi",
    "cffwis_indices", "drought_code", "duff_moisture_code",
    "griffiths_drought_factor", "mcarthur_forest_fire_danger_index",
    "keetch_byram_drought_index",
    "fire_season",
}
MODULES = {"atmos": (jatmos, atmos), "convert": (jconvert, convert)}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("realm", sorted(MODULES))
def test_public_names(realm):
    ref, port = MODULES[realm]
    missing = _public(ref) - _public(port)
    allowed = WAITS_FOR_FIRE if realm == "atmos" else set()
    assert missing == allowed & _public(ref)
    assert not _public(port) - _public(ref)
    assert sorted(getattr(port, "__all__", [])) == sorted(
        n for n in getattr(ref, "__all__", []) if n not in allowed)


def _indicators(realm):
    ref, _ = MODULES[realm]
    return sorted(n for n in _public(ref) - WAITS_FOR_FIRE
                  if isinstance(getattr(ref, n), JIndicator))


@pytest.mark.parametrize("realm,name", [
    (realm, name) for realm in sorted(MODULES) for name in _indicators(realm)])
def test_registry_key_and_identifier(realm, name):
    ref, port = MODULES[realm]
    want, got = getattr(ref, name), getattr(port, name)
    assert isinstance(got, Indicator)
    assert got.identifier == want.identifier
    assert got._registry_key == want._registry_key
    assert got._registry_id == want._registry_id
    assert type(got).__name__ == type(want).__name__
    assert [a["var_name"] for a in got.cf_attrs] == \
        [a["var_name"] for a in want.cf_attrs]


def test_the_fire_list_is_exactly_what_is_missing():
    missing = (_public(jatmos) - _public(atmos)) | (
        _public(jconvert) - _public(convert))
    assert missing == WAITS_FOR_FIRE
