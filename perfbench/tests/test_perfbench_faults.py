"""A run with the program's timed path broken underneath comes out not
correct: an answer altered where it is produced, half of the cells left
out and the mean of the rest put in their place, and an answer altered in
every other call only. (The cells keep no state from call to call and run
on one chip, so a state left unchanged and a missing exchange between chips
are no faults they can have.)"""

import time

import pytest

from perfbench import run
from perfbench.tests.conftest import SEED, tiny_config


def altered(fn, delta):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[0] += delta
        return out
    return broken


def half_left_out(fn):
    """The cells (last axis) of the second half get the mean of the first
    half's answers."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        flat = out.reshape(out.shape[0], out.shape[1], -1) if out.ndim > 3 \
            else out.reshape(*out.shape[:-1], -1)
        h = flat.shape[-1] // 2
        flat[..., h:] = flat[..., :h].mean(dim=-1, keepdim=True)
        return flat.reshape(out.shape)
    return broken


def every_other_call(fn, delta):
    """Alters every other call of an entry the cell's call makes once."""
    calls = [0]

    def broken(*args, **kwargs):
        calls[0] += 1
        out = fn(*args, **kwargs)
        return out + delta if calls[0] % 2 else out
    return broken


WINQ = ("xclim_tpu_torch.ops.winquantile", "doy_window_quantiles")
QDMA = ("xclim_tpu_torch.ops.qdmadjust", "qdm_adjust_series")
PCTQ = ("xclim_tpu_torch.core.percentiles", "nan_quantile")
BOOT = ("xclim_tpu_torch.core.bootstrapping",
        "merge_rank_replaced_year_quantile")

FAULTS = [
    ("qdm65k.train_adjust", WINQ, "altered"),
    ("qdm65k.train_adjust", QDMA, "half"),
    ("qdm65k.train_adjust", QDMA, "some calls"),
    ("qdm65k.adjust", QDMA, "altered"),
    ("qdm65k.adjust", QDMA, "half"),
    ("qdm65k.adjust", QDMA, "some calls"),
    ("tx90p4k.bootstrap", PCTQ, "altered"),
    ("tx90p4k.bootstrap", BOOT, "altered"),
    ("tx90p4k.bootstrap", PCTQ, "half"),
    ("tx90p4k.bootstrap", PCTQ, "some calls"),
    ("tx90p8k.plain", PCTQ, "altered"),
    ("tx90p8k.plain", PCTQ, "half"),
    ("tx90p8k.plain", PCTQ, "some calls"),
]


@pytest.mark.parametrize("cell,target,fault", FAULTS)
def test_broken_path_is_not_correct(bench, cpu, monkeypatch, cell, target,
                                    fault):
    import importlib

    mod = importlib.import_module(target[0])
    fn = getattr(mod, target[1])
    broken = {"altered": lambda: altered(fn, 2.0),
              "half": lambda: half_left_out(fn),
              "some calls": lambda: every_other_call(fn, 2.0)}[fault]()
    monkeypatch.setattr(mod, target[1], broken)
    res, lines = run.run_cell(bench, cell, SEED, 0.2, False, cpu,
                              time.perf_counter(),
                              config=tiny_config(bench, cell))
    assert res["correct"] is False, lines
    failing = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    if fault == "some calls":
        assert "calls_differing" in failing
    assert failing
