"""Tiny configurations of the benchmark's cells, for runs on the CPU."""

import copy

import pytest
import torch

from perfbench import spec

CELLS = ("qdm65k.train_adjust", "tx90p4k.bootstrap", "qdm65k.adjust",
         "tx90p8k.plain")
#: past 2**31, as the seeds a check draws are
SEED = 2**31 + 12345


def tiny_config(bench: dict, cell: str) -> dict:
    """The cell's configuration at a few cells and years."""
    c = copy.deepcopy(spec.config_of(bench, spec.cell(bench, cell)))
    if c["caller"] == "sdba":
        c["data"].update(grid=[2, 3], years=3)
        c["check"]["cells"] = 4
    else:
        c["data"].update(grid=[2, 3], years=6)
        c["method"]["base_years"] = [1961, 1963]
        c["check"]["cells"] = 4
    return c


@pytest.fixture(scope="session")
def bench():
    return spec.load()


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
