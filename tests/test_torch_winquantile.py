"""The winquantile op's plain twin against the JAX package's XLA formulation
``doy_window_quantiles_xla`` on the same numpy doy slices, and the op's
dispatch (CPU tensors go to the twin; the kernel itself is checked on the
card by test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.ops.pallas.winquantile import doy_window_quantiles_xla
from xclim_tpu_torch.ops import winquantile
from xclim_tpu_torch.sdba.utils import equally_spaced_nodes

Q = equally_spaced_nodes(50).astype(np.float32)


def _slices(n_doy, Y, C, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (n_doy, Y, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan       # partly missing lanes
    x[:, :, 0] = np.nan                         # all-NaN lane
    x[:, 1:, 1] = np.nan                        # one valid sample per slice
    x[:, ::2, 2] = np.round(x[:, ::2, 2])       # ties
    if n_doy == 366:
        x[365, 1:, :] = np.nan                  # doy 366: leap years only
    return x


@pytest.mark.parametrize("n_doy,window", [(365, 31), (366, 31), (365, 5),
                                          (366, 5), (360, 1)])
def test_twin_matches_reference(n_doy, window):
    x = _slices(n_doy, 6, 5, seed=n_doy + window)
    got = winquantile.doy_window_quantiles_plain(torch.as_tensor(x), Q, window)
    exp = np.asarray(doy_window_quantiles_xla(jnp.asarray(x), Q, window))
    got = got.numpy()
    assert got.shape == exp.shape == (n_doy, len(Q), 5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # same sort and f32 op sequence; the reference's one-hot einsum rounds
    # the two weighted order statistics within a few ulp (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True)


def test_twin_chunks_over_cells(monkeypatch):
    x = torch.as_tensor(_slices(365, 4, 7, seed=3))
    whole = winquantile.doy_window_quantiles_plain(x, Q, 31)
    monkeypatch.setattr(winquantile, "_SLAB_BYTES", 365 * 31 * 4 * 4 * 2)
    chunked = winquantile.doy_window_quantiles_plain(x, Q, 31)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1 / 3, 1 / 3)])
def test_node_constants_round_like_nan_quantile(alpha, beta):
    qv, coff = winquantile._node_constants(Q, alpha, beta)
    qt = torch.as_tensor(Q)
    np.testing.assert_array_equal(
        coff, (qt * (1 - alpha - beta) + alpha).numpy())
    assert qv.dtype == coff.dtype == np.float32


def test_cpu_tensor_takes_twin_and_counts():
    x = torch.as_tensor(_slices(365, 3, 4, seed=1))
    launches, twins = winquantile.launches, winquantile.twin_calls
    out = winquantile.doy_window_quantiles(x, Q, 5)
    assert winquantile.twin_calls == twins + 1
    assert winquantile.launches == launches
    torch.testing.assert_close(
        out, winquantile.doy_window_quantiles_plain(x, Q, 5), equal_nan=True)


@pytest.mark.parametrize("window,Y,shared", [
    (1, 8192, True), (1, 8193, False), (31, 264, True), (31, 265, False),
    (91, 90, True), (91, 91, False), (31, 300, False), (61, 30, True)])
def test_window_in_shared_up_to_its_limit(window, Y, shared):
    # the padded window (a power of two) must fit MAX_P2 samples; past it
    # the global-scratch instance takes one cell a block
    assert winquantile.window_in_shared(window, Y) is shared
    assert shared == (1 << (window * Y - 1).bit_length()
                      <= winquantile.MAX_P2 == 8192)
    assert (winquantile.cells_per_block(window, Y) == 1) is (
        not shared or window * Y > 4096)


@pytest.mark.parametrize("window,Y,which", [
    (31, 30, "warp"), (31, 33, "warp"), (31, 34, "shared"), (1, 1024, "warp"),
    (1, 1025, "shared"), (5, 204, "warp"), (5, 205, "shared"),
    (1023, 1, "warp"), (1, 0, "warp"), (61, 30, "shared"), (31, 264, "shared"),
    (31, 265, "global"), (1, 8193, "global")])
def test_instance_by_shape(window, Y, which):
    # one warp a cell while the padded window fits 1024 samples, a block's
    # shared memory up to MAX_P2, global scratch past it
    assert winquantile.instance(window, Y) == which
    assert (which == "warp") is (window * Y <= winquantile.WARP_P2 == 1024)
    assert (which == "global") is not winquantile.window_in_shared(window, Y)
    assert (winquantile.cells_per_block(window, Y) == 8) is (which == "warp")


def test_cpu_call_counts_no_warp_launch():
    from xclim_tpu_torch.utils import profiling

    x = torch.as_tensor(_slices(365, 3, 4, seed=2))
    with profiling.tracing() as tr:
        winquantile.doy_window_quantiles(x, Q, 31)
    assert tr.counters["winquantile_warp_launches"] == 0
    (op,) = [s for s in tr.spans if s["name"] == "op.winquantile"]
    assert op["winquantile_warp_launches"] == 0


def _slide_counts_numpy(x, window, nchunk):
    """The valid values entering and leaving a window at each slide, by
    loops: chunk j runs doys j * n // nchunk .. (j + 1) * n // nchunk - 1,
    sorting its first window whole; window 1 never slides."""
    n_doy = x.shape[0]
    half = window // 2
    valid = (~np.isnan(x)).sum(axis=(1, 2))
    entered = left = 0
    for j in range(nchunk):
        g0, g1 = j * n_doy // nchunk, (j + 1) * n_doy // nchunk
        for g in range(g0 + 1, g1):
            if window > 1:
                entered += int(valid[(g + half) % n_doy])
                left += int(valid[(g - 1 - half) % n_doy])
    return entered, left


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("window", [1, 5, 31])
def test_twin_counts_the_values_entering_and_leaving(monkeypatch, window,
                                                     chunks):
    """While tracing, the twin counts winquantile_inserted and
    winquantile_removed at the chunk starts the card would use (one chunk,
    or three of the 40 doys), inside op.winquantile; outside tracing it
    counts nothing and its output is the same."""
    from xclim_tpu_torch.utils import profiling

    groups = -(-20 // winquantile.cells_per_block(window, 6))
    monkeypatch.setattr(winquantile, "TARGET_BLOCKS", groups * chunks)
    monkeypatch.setattr(winquantile, "TARGET_BLOCKS_SMEM", groups * chunks)
    x = _slices(40, 6, 20, seed=window + chunks)
    x[10:13] = np.nan                           # whole slices missing
    nchunk = winquantile.doy_chunks(40, 20, window, 6)
    assert nchunk == chunks
    want = _slide_counts_numpy(x, window, nchunk)
    xt = torch.as_tensor(x)
    off = winquantile.doy_window_quantiles(xt, Q, window)
    with profiling.tracing() as tr:
        on = winquantile.doy_window_quantiles(xt, Q, window)
    assert torch.equal(torch.isnan(off), torch.isnan(on))
    assert torch.equal(torch.nan_to_num(off), torch.nan_to_num(on))
    got = (tr.counters["winquantile_inserted"],
           tr.counters["winquantile_removed"])
    assert got == want
    assert (want[0] > 0) is (window > 1)
    (op,) = [s for s in tr.spans if s["name"] == "op.winquantile"]
    assert (op["winquantile_inserted"], op["winquantile_removed"]) == want
    assert "winquantile_slides" not in tr.counters    # the card's only


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.zeros(5, 3, 2, dtype=torch.float64), TypeError),
    (lambda: torch.zeros(5, 6, dtype=torch.float32), ValueError),
    (lambda: torch.zeros(5, 3, 2, dtype=torch.float32, device="meta"),
     ValueError),
])
def test_rejects_what_neither_path_takes(bad, err):
    with pytest.raises(err):
        winquantile.doy_window_quantiles(bad(), Q, 5)


def test_even_window_rejected():
    with pytest.raises(ValueError, match="odd"):
        winquantile.doy_window_quantiles(torch.zeros(5, 3, 2), Q, 4)


@pytest.mark.parametrize("calendar,window", [("noleap", 31), ("standard", 5)])
def test_doy_gathers_and_windowed_mean(calendar, window):
    from xclim_tpu.core.calendar import date_range as jdate_range
    from xclim_tpu.sdba import utils as jutils
    from xclim_tpu.sdba.grouping import Grouper as JGrouper
    from xclim_tpu_torch.core.calendar import date_range
    from xclim_tpu_torch.sdba import utils as tutils
    from xclim_tpu_torch.sdba.grouping import Grouper

    t = date_range("1981-01-01", periods=4 * 365 + 1, calendar=calendar)
    tj = jdate_range("1981-01-01", periods=4 * 365 + 1, calendar=calendar)
    rng = np.random.default_rng(window)
    xf = rng.normal(285.0, 5.0, (len(t), 3, 2)).astype(np.float32)
    xf[rng.random(xf.shape) < 0.2] = np.nan
    table = Grouper("time.dayofyear", window).device_doy_table(t, "cpu")
    jtable = JGrouper("time.dayofyear", window).doy_table(tj)
    got = tutils.gather_doy_slices(torch.as_tensor(xf), table).numpy()
    exp = np.asarray(jutils.gather_doy_slices(jnp.asarray(xf), jtable))
    np.testing.assert_array_equal(got, exp)
    got = tutils.windowed_doy_mean(torch.as_tensor(xf), table, window).numpy()
    exp = np.asarray(jutils.windowed_doy_mean(jnp.asarray(xf), jtable, window))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # window sums of ~285 K values in another order (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True)


def _cases(n_doy, Y, C, seed, kind):
    """(n_doy, Y, C) slices for the sliding kernel's cases: lane 0 all
    NaN, lane 1 one valid sample in the whole series, lane 2 one valid
    sample per slice, the rest 10 % missing; ``kind`` adds heavy ties
    (values rounded to 0.5 K), +-inf samples, or a doy 366 that only the
    leap years have."""
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (n_doy, Y, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, :, 0] = np.nan
    if C > 1:
        keep = x[n_doy // 2, 0, 1]
        x[:, :, 1] = np.nan
        x[n_doy // 2, 0, 1] = keep
    if C > 2:
        x[:, 1:, 2] = np.nan
    if kind == "ties":
        x = np.round(x * 2.0) / 2.0
    elif kind == "inf":
        x[rng.random(x.shape) < 0.05] = np.inf
        x[rng.random(x.shape) < 0.05] = -np.inf
    elif kind == "sparse366":
        x[365, :, :] = np.nan
        x[365, 3::4, :] = rng.normal(285.0, 5.0, (len(range(3, Y, 4)), C))
    return x.astype(np.float32)


# the kernel's paths: window 1 (presorted slices, no slide), window*Y <=
# 1024 (register sort at each chunk start), above it (shared-memory sort:
# 61 x 30 and 31 x 60 windows of 1830 and 1860 samples)
@pytest.mark.parametrize("n_doy,Y,window,kind", [
    (365, 30, 1, "normal"), (365, 30, 5, "normal"), (365, 30, 31, "normal"),
    (365, 30, 61, "normal"), (365, 1, 31, "normal"), (365, 2, 31, "normal"),
    (365, 60, 31, "normal"), (360, 30, 31, "normal"),
    (366, 30, 31, "sparse366"), (366, 8, 5, "sparse366"),
    (365, 30, 31, "ties"), (365, 30, 61, "ties")])
def test_twin_matches_reference_sliding_cases(n_doy, Y, window, kind):
    x = _cases(n_doy, Y, 5, seed=n_doy * Y + window, kind=kind)
    got = winquantile.doy_window_quantiles_plain(torch.as_tensor(x), Q,
                                                 window).numpy()
    exp = np.asarray(doy_window_quantiles_xla(jnp.asarray(x), Q, window))
    assert got.shape == exp.shape == (n_doy, len(Q), 5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # besides the order statistics' rounding, the reference's compiler fuses
    # h = n*q + c into one rounding where the port rounds twice: the weight
    # can move by an ulp of h (n up to window*Y), times the gap between the
    # order statistics (at most the finite sample range); ROADMAP Queue 3
    xf = x[~np.isnan(x)]
    bound = (3 * np.spacing(np.float32(np.abs(xf).max()))
             + np.spacing(np.float32(window * Y)) * (xf.max() - xf.min()))
    np.testing.assert_allclose(got, exp, rtol=0, atol=bound, equal_nan=True)


def _numpy_window_quantiles(x, q, window):
    """The quantile's float32 op sequence by a loop over (doy, cell), with
    numpy's sort (NaN last; -inf and +inf are ordinary values)."""
    n_doy, Y, C = x.shape
    half = window // 2
    qv, coff = winquantile._node_constants(q, 1.0, 1.0)
    one = np.float32(1.0)
    out = np.full((n_doy, len(qv), C), np.nan, np.float32)
    for g in range(n_doy):
        rows = [(g + o) % n_doy for o in range(-half, half + 1)]
        for c in range(C):
            v = np.sort(x[rows, :, c].reshape(-1))
            n = np.float32(np.count_nonzero(~np.isnan(v)))
            if n == 0:
                continue
            h = np.minimum(np.maximum(n * qv + coff - one, np.float32(0)),
                           n - one)
            k0 = np.floor(h)
            gam = h - k0
            k1 = np.minimum(k0 + one, n - one)
            with np.errstate(invalid="ignore"):
                out[g, :, c] = (v[k0.astype(int)] * (one - gam)
                                + v[k1.astype(int)] * gam)
    return out


# the reference's XLA quantile weighs its order statistics by a one-hot
# einsum, which turns any infinite sample into NaN (inf * 0); the twin and
# the kernel read the two order statistics directly, as this loop does
@pytest.mark.parametrize("n_doy,Y,window", [(365, 30, 31), (365, 2, 1),
                                            (40, 30, 61)])
def test_twin_with_infinite_samples_matches_a_loop(n_doy, Y, window):
    x = _cases(n_doy, Y, 4, seed=Y + window, kind="inf")
    got = winquantile.doy_window_quantiles_plain(torch.as_tensor(x), Q,
                                                 window).numpy()
    exp = _numpy_window_quantiles(x, Q, window)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    assert (got[~np.isnan(exp)] == exp[~np.isnan(exp)]).all()


@pytest.mark.parametrize("n_doy,C,window,Y,want", [
    (365, 16384, 31, 30, 2), (365, 1024, 31, 30, 32), (365, 1, 31, 30, 365),
    (366, 4096, 5, 30, 8), (365, 1024, 61, 30, 4), (5, 8, 31, 30, 5),
    (365, 8192, 31, 60, 1), (365, 4096, 1, 30, 8), (365, 1024, 31, 8, 32),
    (365, 1024, 11, 30, 32)])
def test_doy_chunk_plan(n_doy, C, window, Y, want):
    assert winquantile.doy_chunks(n_doy, C, window, Y) == want
    groups = -(-C // winquantile.cells_per_block(window, Y))
    # enough blocks for the card, or one chunk per doy; a window sorted in
    # shared memory (over 1024 samples) aims for fewer blocks
    P2 = max(32, 1 << (window * Y - 1).bit_length())
    target = (winquantile.TARGET_BLOCKS if P2 <= 1024
              else winquantile.TARGET_BLOCKS_SMEM)
    assert groups * want >= target or want == n_doy
    assert groups * (want - 1) < target


@pytest.mark.parametrize("window,Y", [(1, 30), (31, 30), (61, 30), (31, 60),
                                      (5, 1)])
def test_cells_per_block(window, Y):
    P2 = 1 << (window * Y - 1).bit_length()
    want = 8 if max(P2, 32) <= 1024 else 8192 // P2
    assert winquantile.cells_per_block(window, Y) == want


@pytest.mark.parametrize("window,kind", [(1, "normal"), (31, "normal"),
                                         (61, "inf"), (5, "sparse366")])
def test_stage_plain_against_the_twin(window, kind):
    n_doy = 366 if kind == "sparse366" else 365
    x = torch.as_tensor(_cases(n_doy, 4, 6, seed=window, kind=kind))
    count = winquantile.stage_plain(x, Q, window, 0)
    low = winquantile.stage_plain(x, Q, window, 1)
    assert count.shape == low.shape == (n_doy, 6)
    assert count.dtype == torch.float32
    # by a loop over the window's slices
    half = window // 2
    valid = (~torch.isnan(x)).sum(dim=1)
    lows = torch.where(torch.isnan(x), torch.inf, x).amin(dim=1)
    n_loop = sum(valid.roll(-o, dims=0) for o in range(-half, half + 1))
    lo_loop = torch.stack([lows.roll(-o, dims=0)
                           for o in range(-half, half + 1)]).amin(dim=0)
    assert torch.equal(count, n_loop.float())
    torch.testing.assert_close(low, torch.where(n_loop > 0, lo_loop,
                                                torch.nan),
                               rtol=0, atol=0, equal_nan=True)
    # against the twin: no valid sample <-> NaN quantile; with finite
    # samples the 0-quantile is the smallest valid one (alpha = beta = 1:
    # h = 0, weight 0 on the next order statistic)
    full = winquantile.doy_window_quantiles_plain(x, [0.0, 0.5], window)
    if kind != "inf":
        assert torch.equal(count == 0, torch.isnan(full[:, 1]))
        torch.testing.assert_close(low, full[:, 0], rtol=0, atol=0,
                                   equal_nan=True)
    torch.testing.assert_close(
        winquantile.stage_plain(x, Q, window, 2),
        winquantile.doy_window_quantiles_plain(x, Q, window), rtol=0, atol=0,
        equal_nan=True)


def test_stage_on_cpu_takes_plain_and_checks():
    x = torch.as_tensor(_cases(365, 3, 4, seed=2, kind="normal"))
    before = winquantile.stage_launches
    torch.testing.assert_close(winquantile.doy_window_stage(x, Q, 5, 1),
                               winquantile.stage_plain(x, Q, 5, 1),
                               equal_nan=True)
    assert winquantile.stage_launches == before
    with pytest.raises(ValueError, match="stage"):
        winquantile.doy_window_stage(x, Q, 5, 3)
