"""Name parity of the port's indicator realms (``atmos``, ``convert``,
``land``, ``seaIce``, ``generic``): the same public names as the JAX
package's modules, the same ``__all__``, and for each indicator the same
registry key, registry id, ``identifier``, class name and output
``var_name``s. With the fire slice ported nothing is missing."""

import pytest

import xclim_tpu.indicators.atmos as jatmos
import xclim_tpu.indicators.convert as jconvert
import xclim_tpu.indicators.generic as jgeneric
import xclim_tpu.indicators.land as jland
import xclim_tpu.indicators.seaIce as jseaice
from xclim_tpu.core.indicator import Indicator as JIndicator
from xclim_tpu_torch.core.indicator import Indicator
from xclim_tpu_torch.indicators import atmos, convert, generic, land, seaIce

MODULES = {"atmos": (jatmos, atmos), "convert": (jconvert, convert),
           "land": (jland, land), "seaIce": (jseaice, seaIce),
           "generic": (jgeneric, generic)}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


@pytest.mark.parametrize("realm", sorted(MODULES))
def test_public_names(realm):
    ref, port = MODULES[realm]
    assert _public(port) == _public(ref)
    assert sorted(getattr(port, "__all__", [])) == sorted(
        getattr(ref, "__all__", []))


def _indicators(realm):
    ref, _ = MODULES[realm]
    return sorted(n for n in _public(ref)
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
    """The list of names waiting for ``indices/fire/`` is empty: no realm
    of the reference has a public name the port lacks."""
    missing = set().union(*(_public(ref) - _public(port)
                            for ref, port in MODULES.values()))
    assert missing == set()
