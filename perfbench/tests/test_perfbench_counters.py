"""The readers of the kernels' counters (``perfbench/counters.py`` and the
four metrics that read it) on a fake second stretch: the counters of the
last ``tracing()`` block give each ratio; a run without the stretch, a
program without ``last_trace`` (the parent's) or without the counter
gives nothing to read."""

from types import SimpleNamespace

import pytest

from perfbench import run
from xclim_tpu_torch.utils import profiling

COUNTERS = {
    "winquantile_slides": 6400, "winquantile_sampled_slides": 200,
    "winquantile_cycles_sort": 10_000,
    "winquantile_cycles_slices": 200_000, "winquantile_cycles_walk": 1_400_000,
    "winquantile_cycles_nodes": 390_000, "winquantile_walk_steps": 6400,
    "winquantile_walk_branch_steps": 5000,
    "winquantile_walk_branch_lanes": 12_000,
    "winquantile_inserted": 6000, "winquantile_removed": 6000,
    "betainc_element_terms": 1150, "betainc_elements": 100,
}
READERS = {
    "winquantile.cycles_per_slide": 2_000_000 / 200,
    "winquantile.walk_cycles_per_slide": 1_400_000 / 200,
    "winquantile.walk_lane_pct": 100 * 12_000 / (32 * 5000),
    "betainc.terms_per_element": 11.5,
}
#: the counter each reader divides by
DENOMINATOR = {
    "winquantile.cycles_per_slide": "winquantile_sampled_slides",
    "winquantile.walk_cycles_per_slide": "winquantile_sampled_slides",
    "winquantile.walk_lane_pct": "winquantile_walk_branch_steps",
    "betainc.terms_per_element": "betainc_elements",
}


def _stretch():
    return SimpleNamespace(program={"calls": 4})


def _last(monkeypatch, counters):
    trace = profiling.Trace()
    trace.counters.update(counters)
    monkeypatch.setattr(profiling, "_last", trace)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_the_last_blocks_counters(monkeypatch, name):
    _last(monkeypatch, COUNTERS)
    assert run.metric_reader(name).read(_stretch()) == \
        pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_without_the_stretch_or_the_counter(monkeypatch,
                                                            name):
    r = run.metric_reader(name)
    _last(monkeypatch, COUNTERS)
    assert r.read(SimpleNamespace(program=None)) is None
    # the counter never counted: the other kernel ran, or none did
    _last(monkeypatch, {k: v for k, v in COUNTERS.items()
                        if k != DENOMINATOR[name]})
    assert r.read(_stretch()) is None
    _last(monkeypatch, {})
    assert r.read(_stretch()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_program_without_last_trace_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "last_trace")
    assert run.metric_reader(name).read(_stretch()) is None
