"""The port's segment engine (ops/segments.py) and the segred op's plain twin
(ops/segred.py) against the JAX package on the same numpy inputs.

The reference on the CPU is ``segment_reduce(..., _no_pallas=True)``: its
slice-unroll and gather paths, held at 1e-6. The Pallas kernel itself runs
in interpret mode and is held at the reference's own 1e-5
(tests/test_segred.py): its sum splits each value into three bf16 parts.
The CUDA kernel is checked against the twin on the card by
test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.core.calendar import date_range as jdate_range
from xclim_tpu.core.calendar import resample_segments as jresample_segments
from xclim_tpu.ops import segments as jsegments
from xclim_tpu.ops.pallas.segred import segment_reduce_onepass as jonepass
from xclim_tpu_torch.core.calendar import date_range, resample_segments
from xclim_tpu_torch.ops import segments, segred

CALENDARS = ["noleap", "360_day", "standard"]
FREQS = ["MS", "YS", "QS-DEC"]
KERNEL_OPS = sorted(segred.SUPPORTED_OPS)
OTHER_OPS = ["median", "prod", "any", "all"]
NY, NX = 3, 4


def _series(T, seed, kind="K"):
    """(T, NY, NX) float32 with 10 % NaN holes, an all-NaN lane (0, 0) and
    an all-NaN February in lane (1, 2)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (T, NY, NX)).astype(np.float32)
    if kind == "ratio":        # near 1: a product over a year stays finite
        x = (1.0 + (x - 285.0) / 500.0).astype(np.float32)
    elif kind == "mask":       # 0/1 values: any/all have both outcomes
        x = (x > 288.0).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 0, 0] = np.nan
    x[31:59, 1, 2] = np.nan
    return x


def _specs(cal, freq, years=2):
    n = {"noleap": 365, "360_day": 360, "standard": 365}[cal] * years
    if cal == "standard":
        n += 1                 # 2000 is a leap year
    t = date_range("2000-01-01", periods=n, calendar=cal)
    jt = jdate_range("2000-01-01", periods=n, calendar=cal)
    return n, resample_segments(t, freq), jresample_segments(jt, freq)


def _same(got, exp, rtol=1e-6, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    exp = np.asarray(exp)
    assert got.shape == exp.shape
    if exp.dtype.kind in "biu":
        assert got.dtype == exp.dtype, (got.dtype, exp.dtype)
        np.testing.assert_array_equal(got, exp)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=atol, equal_nan=True)


def _kind(op):
    return {"prod": "ratio", "any": "mask", "all": "mask"}.get(op, "K")


@pytest.mark.parametrize("cal", CALENDARS)
@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("op", KERNEL_OPS + OTHER_OPS)
def test_segment_reduce_matches_reference(op, freq, cal):
    T, spec, jspec = _specs(cal, freq)
    x = _series(T, seed=len(op) + T, kind=_kind(op))
    got = segments.segment_reduce(torch.as_tensor(x), spec, op, axis=0)
    exp = jsegments.segment_reduce(jnp.asarray(x), jspec, op, axis=0,
                                   _no_pallas=True)
    # both sum 365 float32 values; the reference rounds each partial sum
    # and the port rounds a float64 sum once: a few ulp (1e-6, SURVEY §6).
    # A float32 product rounds at each of its 365 factors on both sides,
    # in another order: up to ~sqrt(365) ulp apart, so 1e-5 there
    _same(got, exp, rtol=1e-5 if op == "prod" else 1e-6)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "count", "std",
                                "var", "median"])
def test_segment_reduce_skipna_false(op):
    T, spec, jspec = _specs("noleap", "MS")
    x = _series(T, seed=3)
    got = segments.segment_reduce(torch.as_tensor(x), spec, op, skipna=False)
    exp = jsegments.segment_reduce(jnp.asarray(x), jspec, op, skipna=False,
                                   _no_pallas=True)
    _same(got, exp)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min", "count", "any",
                                "all", "prod"])
@pytest.mark.parametrize("dtype", ["bool", "int32"])
def test_segment_reduce_integer_input(op, dtype):
    T, spec, jspec = _specs("noleap", "QS-DEC")
    rng = np.random.default_rng(5)
    x = (rng.random((T, NY, NX)) < 0.5).astype(dtype)
    if op == "prod":          # a few 2s a quarter: the product fits int32
        x = (1 + (rng.random((T, NY, NX)) < 0.05)).astype(dtype)
    got = segments.segment_reduce(torch.as_tensor(x), spec, op)
    exp = jsegments.segment_reduce(jnp.asarray(x), jspec, op, _no_pallas=True)
    _same(got, exp)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_segment_reduce_any_time_axis(axis):
    T, spec, jspec = _specs("360_day", "MS")
    x = np.moveaxis(_series(T, seed=9), 0, axis).copy()
    got = segments.segment_reduce(torch.as_tensor(x), spec, "mean", axis=axis)
    exp = jsegments.segment_reduce(jnp.asarray(x), jspec, "mean", axis=axis,
                                   _no_pallas=True)
    _same(got, exp)


def test_time_first_input_reaches_the_op_as_a_view(monkeypatch):
    T, spec, _ = _specs("noleap", "MS")
    x = torch.as_tensor(_series(T, seed=1))
    seen = []
    real = segred.segment_reduce_onepass

    def spy(x2, starts, counts, op):
        seen.append(x2)
        return real(x2, starts, counts, op)

    monkeypatch.setattr(segred, "segment_reduce_onepass", spy)
    segments.segment_reduce(x, spec, "mean")
    assert seen[0].data_ptr() == x.data_ptr() and seen[0].is_contiguous()
    assert tuple(seen[0].shape) == (T, NY * NX)


def test_dispatch_counts_on_cpu():
    T, spec, _ = _specs("noleap", "YS")
    x = torch.as_tensor(_series(T, seed=2))
    before = (segred.launches, segred.twin_calls)
    for op in KERNEL_OPS:
        segments.segment_reduce(x, spec, op)
    assert (segred.launches, segred.twin_calls) == (
        before[0], before[1] + len(KERNEL_OPS))
    # median, skipna=False and integer input take the gather path
    segments.segment_reduce(x, spec, "median")
    segments.segment_reduce(x, spec, "sum", skipna=False)
    segments.segment_reduce(x > 285.0, spec, "sum")
    assert (segred.launches, segred.twin_calls) == (
        before[0], before[1] + len(KERNEL_OPS))


@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("op", KERNEL_OPS)
def test_twin_matches_pallas_interpret(op, freq):
    T, spec, jspec = _specs("noleap", freq)
    x = _series(T, seed=7).reshape(T, -1)
    got = segred.segment_reduce_onepass_plain(torch.as_tensor(x), spec.starts,
                                              spec.counts, op)
    exp = jonepass(jnp.asarray(x), jspec, op, interpret=True)
    # the Pallas sum splits each value into three bf16 parts on the matrix
    # unit, so the reference holds it at 1e-5 (tests/test_segred.py)
    _same(got, exp, rtol=1e-5, atol=1e-5)


def test_twin_nan_rules():
    x = torch.tensor([[1.0, np.nan], [3.0, np.nan], [np.nan, np.nan],
                      [5.0, np.nan]])
    starts, counts = [0, 2, 4], [2, 2, 0]
    cnt = segred.segment_reduce_onepass(x, starts, counts, "count")
    assert cnt.dtype == torch.int32
    assert cnt.tolist() == [[2, 0], [1, 0], [0, 0]]
    for op in ("sum", "mean", "min", "max", "std", "var"):
        out = segred.segment_reduce_onepass(x, starts, counts, op)
        assert out.dtype == torch.float32
        assert torch.isnan(out[:, 1]).all() and torch.isnan(out[2, 0])
    var = segred.segment_reduce_onepass(x, starts, counts, "var")
    assert var[:2, 0].tolist() == [1.0, 0.0]          # ddof=0


def test_op_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="serves"):
        segred.segment_reduce_onepass(x, [0], [10], "median")
    with pytest.raises(TypeError, match="float32"):
        segred.segment_reduce_onepass(x.double(), [0], [10], "sum")
    with pytest.raises(ValueError, match="exceed"):
        segred.segment_reduce_onepass(x, [0, 5], [5, 6], "sum")
    # a tensor that is neither on the CPU nor on a CUDA card gets no twin
    with pytest.raises(ValueError, match="no segred kernel"):
        segred.segment_reduce_onepass(torch.zeros(10, 3, device="meta"),
                                      [0], [10], "sum")


@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_argminmax_exact(op, freq):
    T, spec, jspec = _specs("standard", freq)
    x = _series(T, seed=11)
    x[100:110, 2, 3] = 290.0                  # ties: first occurrence wins
    idx, has = segments.segment_argminmax(torch.as_tensor(x), spec, op)
    jidx, jhas = jsegments.segment_argminmax(jnp.asarray(x), jspec, op)
    _same(idx, jidx)
    _same(has, jhas)


@pytest.mark.parametrize("freq", FREQS)
@pytest.mark.parametrize("which", ["first", "last"])
def test_segment_first_last(which, freq):
    T, spec, jspec = _specs("360_day", freq)
    x = _series(T, seed=13)
    got = segments.segment_first_last(torch.as_tensor(x), spec, which)
    exp = jsegments.segment_first_last(jnp.asarray(x), jspec, which)
    _same(got, exp, rtol=0.0)


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("min_periods", [None, 2])
@pytest.mark.parametrize("window,op", [(5, "sum"), (5, "mean"), (4, "max"),
                                       (3, "min"), (5, "std"), (6, "var")])
def test_rolling_reduce(op, window, center, min_periods):
    x = _series(90, seed=window)
    x -= 285.0                                # E[x^2]-E[x]^2 near zero mean
    got = segments.rolling_reduce(torch.as_tensor(x), window, op,
                                  min_periods=min_periods, center=center)
    exp = jsegments.rolling_reduce(jnp.asarray(x), window, op,
                                   min_periods=min_periods, center=center)
    _same(got, exp, atol=1e-6)


def test_gather_table_matches_reference():
    T, spec, jspec = _specs("standard", "QS-DEC")
    np.testing.assert_array_equal(segments.build_gather_table(spec),
                                  jsegments.build_gather_table(jspec))
