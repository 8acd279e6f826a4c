"""The generators: deterministic from the seed, and the AR(1) scan equal to
its recurrence."""

import math

import pytest
import torch

from perfbench import generate, spec
from perfbench.tests.conftest import CELLS, SEED, tiny_config


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(bench, cell):
    data = tiny_config(bench, cell)["data"]
    a = generate.make(data, SEED, "cpu")
    b = generate.make(data, SEED, "cpu")
    c = generate.make(data, SEED + 1, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == torch.float32
        assert a[k].shape == (data["years"] * 365, *data["grid"])
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k])


def test_ar1_scan_is_the_recurrence():
    data = {"kind": "ar1_tasmax", "calendar": "noleap", "years": 2,
            "grid": [3], "mean_K": 0.0, "season_K": 0.0,
            "season_phase_doy": 0, "anomaly_K": 1.0, "phi": 0.8}
    got = generate.make(data, SEED, "cpu")["tasmax"].double()
    gen = torch.Generator()
    gen.manual_seed(SEED)
    e = torch.randn((730, 3), generator=gen).double()
    e[1:] *= math.sqrt(1 - 0.64)
    want = e.clone()
    for t in range(1, 730):
        want[t] = 0.8 * want[t - 1] + e[t]
    assert torch.allclose(got, want, atol=1e-5)


def test_configs_state_their_sizes(bench):
    for c in bench["configs"]:
        cfg = spec.config_of(bench, {"config": c["name"]})
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert cfg["assumed"] and cfg["data"]["calendar"] == "noleap"
