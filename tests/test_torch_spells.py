"""The port's spells twin (ops/spells.py) against the JAX package: its
Pallas kernel ``fused_spell_stats`` in interpret mode, and its XLA route
(``ops/runlength.py`` with the XLA spell engine and the segment sum). The
four outputs are integer counts in float32, so both comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.calendar import resample_segments as jresample_segments
from xclim_tpu.ops import runlength as jrl
from xclim_tpu.ops.pallas import capability
from xclim_tpu.ops.pallas.spells import fused_spell_stats
from xclim_tpu.ops.segments import segment_reduce as jsegment_reduce
from xclim_tpu_torch.core.calendar import date_range, resample_segments
from xclim_tpu_torch.ops import runlength, spells

OPS = {">": np.greater, ">=": np.greater_equal, "<": np.less,
       "<=": np.less_equal}
THRESH = 0.5
CELLS = 12


@pytest.fixture(autouse=True)
def _xla_reference_route():
    """Pin the reference's spell engine to its XLA route (Pallas off) while
    a test builds references, and restore the module state after."""
    mode, engine = capability._MODE, capability._SPELL_ENGINE
    capability.set_pallas_mode("off")
    capability.set_spell_engine("xla")
    yield
    capability.set_pallas_mode(mode)
    capability.set_spell_engine(engine)


def _series(T, seed):
    """(T, CELLS) float32: AR(1) lanes (runs of every length), a lane with
    15 % NaN, an all-NaN lane, an all-True and an all-False lane for every
    op, and a lane whose runs straddle every month and year boundary."""
    rng = np.random.default_rng(seed)
    e = rng.normal(0.0, 1.0, (T, CELLS))
    x = np.zeros((T, CELLS))
    for t in range(1, T):
        x[t] = 0.8 * x[t - 1] + 0.6 * e[t]
    x = x.astype(np.float32)
    x[rng.random(T) < 0.15, 1] = np.nan
    x[:, 2] = np.nan
    x[:, 3] = THRESH          # True for >= and <=, False for > and <
    x[:, 4] = 10.0            # True for > and >=
    x[:, 5] = -10.0           # True for < and <=
    # lane 6: 8-day runs centred on days 0, 30, 60, ... (month and year
    # ends fall inside some of them)
    day = np.arange(T)
    x[:, 6] = np.where((day + 4) % 30 < 8, 10.0, -10.0)
    return x


def _specs(cal, freq, T):
    t = date_range("2000-01-01", periods=T, calendar=cal)
    jt = jdate_range("2000-01-01", periods=T, calendar=cal)
    return resample_segments(t, freq), jresample_segments(jt, freq)


GRID = [(op, w) for op in OPS for w in range(1, 7)]


@pytest.mark.parametrize("cal", ["noleap", "360_day"])
@pytest.mark.parametrize("freq", ["MS", "YS", "QS-DEC"])
@pytest.mark.parametrize("op,window", GRID)
def test_twin_matches_interpret_kernel(op, window, freq, cal):
    T = 730 if cal == "noleap" else 720
    x = _series(T, seed=window)
    spec, jspec = _specs(cal, freq, T)
    got = spells.spell_stats(torch.as_tensor(x), spec.starts, spec.counts,
                             window, op, THRESH)
    exp = fused_spell_stats(jnp.asarray(x), jspec, THRESH, window, op,
                            interpret=True)
    for g, e, name in zip(got, exp, ("cnt", "wrc", "wre", "lng")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)


@pytest.mark.parametrize("cal", ["noleap", "360_day"])
@pytest.mark.parametrize("freq", ["MS", "YS", "QS-DEC"])
@pytest.mark.parametrize("op,window", GRID)
def test_twin_matches_xla_route(op, window, freq, cal):
    T = 730 if cal == "noleap" else 720
    x = _series(T, seed=window + 10)
    spec, jspec = _specs(cal, freq, T)
    b = OPS[op](x, THRESH) & ~np.isnan(x)
    jb = jnp.asarray(b)
    exp = (jsegment_reduce(jb.astype(jnp.float32), jspec, "sum"),
           jrl.windowed_run_count(jb, window, spec=jspec),
           jrl.windowed_run_events(jb, window, spec=jspec),
           jrl.longest_run(jb, spec=jspec))
    got = spells.spell_stats(torch.as_tensor(x), spec.starts, spec.counts,
                             window, op, THRESH)
    for g, e, name in zip(got, exp, ("cnt", "wrc", "wre", "lng")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)
    # the bool condition and the public run-length calls give the same
    cond = torch.as_tensor(b)
    for g, fn in zip(got[1:], (
            lambda: runlength.windowed_run_count(cond, window, spec=spec),
            lambda: runlength.windowed_run_events(cond, window, spec=spec),
            lambda: runlength.longest_run(cond, spec=spec))):
        np.testing.assert_array_equal(fn().numpy(), g.numpy())


def test_bool_condition_in_batch_layout_matches_per_batch():
    # the bootstrap's condition: logical (time, cell, replacement),
    # replacement-major in memory
    T = 730
    spec, _ = _specs("noleap", "YS", T)
    x = torch.as_tensor(_series(T, seed=3))
    th = torch.as_tensor(np.random.default_rng(4).normal(
        0.0, 0.5, (5, T, CELLS)).astype(np.float32))
    cond = x[:, :, None] > th.permute(1, 2, 0)
    assert not cond.is_contiguous()
    got = spells.spell_stats(cond, spec.starts, spec.counts, 4)
    for r in range(5):
        one = spells.spell_stats(cond[:, :, r].contiguous(), spec.starts,
                                 spec.counts, 4)
        for g, e in zip(got, one):
            np.testing.assert_array_equal(g[:, :, r].numpy(), e.numpy())


def test_time_on_another_axis():
    T = 730
    spec, _ = _specs("noleap", "MS", T)
    x = torch.as_tensor(_series(T, seed=5))
    got = spells.spell_stats(x.T, spec.starts, spec.counts, 3, ">", THRESH,
                             axis=1)
    exp = spells.spell_stats(x, spec.starts, spec.counts, 3, ">", THRESH)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), e.T.numpy())


def test_uneven_bounds_match_a_loop():
    rng = np.random.default_rng(6)
    b = rng.random((50, 5)) > 0.3
    starts, counts = [0, 3, 3, 10, 40], [3, 0, 7, 1, 10]
    got = spells.spell_stats(torch.as_tensor(b), starts, counts, 2)
    for s, (a, n) in enumerate(zip(starts, counts)):
        for c in range(5):
            run = cnt = wrc = wre = lng = 0
            for t in range(a, a + n):
                run = run + 1 if b[t, c] else 0
                cnt += int(b[t, c])
                wrc += 2 if run == 2 else int(run > 2)
                wre += int(run == 2)
                lng = max(lng, run)
            assert [float(o[s, c]) for o in got] == [cnt, wrc, wre, lng]


def test_wrapper_checks_and_counters():
    x = torch.zeros(10, 2)
    with pytest.raises(ValueError, match="op"):
        spells.spell_stats(x, [0], [10], 2)
    with pytest.raises(ValueError, match="no op"):
        spells.spell_stats(x > 0, [0], [10], 2, ">", 0.0)
    with pytest.raises(TypeError):
        spells.spell_stats(x.double(), [0], [10], 2, ">", 0.0)
    with pytest.raises(ValueError, match="window"):
        spells.spell_stats(x, [0], [10], 0, ">", 0.0)
    with pytest.raises(ValueError, match="disjoint"):
        spells.spell_stats(x, [0, 4], [5, 5], 2, ">", 0.0)
    before = (spells.launches, spells.twin_calls)
    spells.spell_stats(x, [0, 5], [5, 5], 2, ">", 0.0)
    assert (spells.launches, spells.twin_calls) == (before[0], before[1] + 1)


def _edge_specs(kind, T):
    """(port starts/counts, reference SegmentSpec) for the cases the
    kernel's (batch, segment, cells) split must handle: one segment over
    the whole series, one-day segments, and YS periods."""
    from xclim_tpu.core.calendar import SegmentSpec as JSegmentSpec

    if kind == "YS":
        spec, jspec = _specs("noleap", "YS", T)
        return (spec.starts, spec.counts), jspec
    if kind == "whole":
        seg_id = np.zeros(T, np.int32)
    else:                                   # one-day segments
        seg_id = np.arange(T, dtype=np.int32)
    nseg = int(seg_id[-1]) + 1
    counts = np.bincount(seg_id, minlength=nseg).astype(np.int32)
    jspec = JSegmentSpec(freq=kind, seg_id=seg_id, nseg=nseg, counts=counts,
                         expected=counts, labels=None)
    return (jspec.starts, counts), jspec


# segments shorter than the window (one day; a 400-day window in 365-day
# years), one segment over the whole series, and cell counts that are not
# a multiple of the kernel's 4-cell groups
@pytest.mark.parametrize("kind", ["whole", "day", "YS"])
@pytest.mark.parametrize("window", [1, 3, 400])
@pytest.mark.parametrize("cells", [5, 17])
def test_twin_matches_interpret_kernel_edge_segments(kind, window, cells):
    T = 730
    x = np.tile(_series(T, seed=window + cells), (1, 2))[:, :cells]
    (starts, counts), jspec = _edge_specs(kind, T)
    got = spells.spell_stats(torch.as_tensor(x), starts, counts, window, ">",
                             THRESH)
    exp = fused_spell_stats(jnp.asarray(x), jspec, THRESH, window, ">",
                            interpret=True)
    for g, e, name in zip(got, exp, ("cnt", "wrc", "wre", "lng")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)


@pytest.mark.parametrize("kind", ["whole", "YS"])
def test_twin_matches_xla_route_at_1000_cells(kind):
    T = 730
    rng = np.random.default_rng(7)
    b = rng.random((T, 1000)) < 0.6
    (starts, counts), jspec = _edge_specs(kind, T)
    got = spells.spell_stats(torch.as_tensor(b), starts, counts, 3)
    jb = jnp.asarray(b)
    exp = (jsegment_reduce(jb.astype(jnp.float32), jspec, "sum"),
           jrl.windowed_run_count(jb, 3, spec=jspec),
           jrl.windowed_run_events(jb, 3, spec=jspec),
           jrl.longest_run(jb, spec=jspec))
    for g, e, name in zip(got, exp, ("cnt", "wrc", "wre", "lng")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=name)


def test_batch_layout_matches_interpret_kernel():
    # the bootstrap's replacement-major condition against the reference's
    # kernel, one replacement at a time (True as 1.0 > 0.5)
    T = 730
    spec, jspec = _specs("noleap", "YS", T)
    x = torch.as_tensor(_series(T, seed=8))
    th = torch.as_tensor(np.random.default_rng(9).normal(
        0.0, 0.5, (3, T, CELLS)).astype(np.float32))
    cond = x[:, :, None] > th.permute(1, 2, 0)
    got = spells.spell_stats(cond, spec.starts, spec.counts, 3)
    for r in range(3):
        exp = fused_spell_stats(jnp.asarray(cond[:, :, r].float().numpy()),
                                jspec, 0.5, 3, ">", interpret=True)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g[:, :, r].numpy(), np.asarray(e))


def test_devices_without_a_kernel_are_refused():
    # neither the CPU twin nor the CUDA kernel: raise, never fall back
    before = (spells.launches, spells.twin_calls)
    with pytest.raises(ValueError, match="no spells kernel"):
        spells.spell_stats(torch.zeros(10, 16, dtype=torch.bool,
                                       device="meta"), [0], [10], 2)
    assert (spells.launches, spells.twin_calls) == before


@pytest.mark.parametrize("B,nseg,C,longest,want", [
    (29, 30, 4096, 365, 1), (1, 30, 1024, 365, 3), (1, 1, 1024, 10950, 66),
    (1, 1, 1000, 10950, 68), (1, 1, 4, 100, 1), (1, 0, 4, 0, 1),
    (1, 730, 4096, 1, 1)])
def test_time_parts(B, nseg, C, longest, want):
    counts = [longest] * nseg
    got = spells.time_parts(B, nseg, C, counts)
    assert got == want
    # enough threads, or parts of at least SPLIT_DAYS days
    assert (B * nseg * C * got >= spells.SPLIT_THREADS
            or got == max(1, longest // spells.SPLIT_DAYS))
