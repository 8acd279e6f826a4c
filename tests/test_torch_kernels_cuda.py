"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. These need an NVIDIA GPU with nvcc and skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from xclim_tpu_torch.core.calendar import date_range, resample_segments
from xclim_tpu_torch.ops import (
    axisquantile,
    bootstrap,
    qdmadjust,
    segred,
    spells,
    winquantile,
)
from xclim_tpu_torch.ops.quantile import nan_quantile
from xclim_tpu_torch.sdba.utils import equally_spaced_nodes
from xclim_tpu_torch.testing import check_chill_portions

# the string condition is evaluated when each test is set up, not when the
# module is imported, so every worker collects the same tests
pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU: the CUDA kernels have no CPU mode")]

Q = equally_spaced_nodes(50).astype(np.float32)


@pytest.fixture(scope="module")
def cuda():
    return torch.device("cuda")


def _slices(n_doy, Y, C, seed, nanfrac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (n_doy, Y, C)).astype(np.float32)
    x[rng.random(x.shape) < nanfrac] = np.nan
    x[:, :, 0] = np.nan                          # all-NaN lane
    if C > 1:
        x[:, 1:, 1] = np.nan                     # single valid sample
    if C > 2:
        x[:, ::2, 2] = np.round(x[:, ::2, 2])    # ties
    return x


def _value_equal(got, exp):
    # the same float32 op sequence, value for value (-0.0 == 0.0)
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    assert got.shape == exp.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    ok = ~np.isnan(exp)
    assert (got[ok] == exp[ok]).all()


def _close(got, exp):
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # one f32 op sequence on both paths (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6, equal_nan=True)


# padded window P2 = next pow2 of window*Y: 1024, 256, 8, 128, 2048, 4,
# 64, 512 take the register sort (P2 <= 1024) or the shared-memory sort
# (2048 with 4 cells a block, 4096 with 2, 8192 with 1)
@pytest.mark.parametrize("n_doy,Y,C,window", [
    (365, 30, 300, 31), (366, 30, 300, 5), (360, 7, 37, 1),
    (365, 3, 5, 31), (365, 64, 40, 31), (10, 1, 9, 3), (20, 12, 10, 5),
    (365, 16, 20, 31), (365, 100, 5, 31), (40, 200, 3, 31)])
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1 / 3, 1 / 3)])
def test_winquantile_kernel_matches_twin(cuda, n_doy, Y, C, window, alpha,
                                         beta):
    x = torch.as_tensor(_slices(n_doy, Y, C, seed=n_doy + Y + C), device=cuda)
    before = winquantile.launches
    got = winquantile.doy_window_quantiles(x, Q, window, alpha, beta)
    torch.cuda.synchronize()
    assert winquantile.launches == before + 1
    _close(got, winquantile.doy_window_quantiles_plain(x, Q, window, alpha,
                                                       beta))


# past MAX_P2 padded samples the windows (or, past 8192 years, the
# presorted slices) live in global scratch: w31 x 300 years = 9300 samples
# with slides and with every doy its own chunk, and 9000 years at window 3
# (slides over presorted slices, 4 doy chunks) and window 1
@pytest.mark.parametrize("n_doy,Y,C,window", [
    (365, 300, 4, 31), (30, 300, 3, 31), (6, 9000, 300, 3), (4, 9000, 2, 1)])
def test_winquantile_past_shared_memory_takes_global_scratch(cuda, n_doy, Y,
                                                             C, window):
    assert not winquantile.window_in_shared(window, Y)
    x = torch.as_tensor(_slices(n_doy, Y, C, seed=Y + window), device=cuda)
    counts = (winquantile.launches, winquantile.global_launches,
              winquantile.twin_calls)
    got = winquantile.doy_window_quantiles(x, Q, window)
    torch.cuda.synchronize()
    assert (winquantile.launches, winquantile.global_launches,
            winquantile.twin_calls) == (counts[0] + 1, counts[1] + 1,
                                        counts[2])
    _value_equal(got, winquantile.doy_window_quantiles_plain(x, Q, window))
    # the stage profile takes the same instance
    for stage in (0, 1):
        _value_equal(winquantile.doy_window_stage(x, Q, window, stage),
                     winquantile.stage_plain(x, Q, window, stage))


def test_qdm_train_over_the_window_limit_on_the_card(cuda):
    from xclim_tpu_torch.core.dataarray import ClimArray
    from xclim_tpu_torch.sdba import Grouper, QuantileDeltaMapping

    t = date_range("1701-01-01", periods=300 * 365, calendar="noleap")
    rng = np.random.default_rng(300)
    data = {k: rng.normal(mu, 5.0, (len(t), 3)).astype(np.float32)
            for k, mu in (("ref", 285.0), ("hist", 287.0))}

    def train(device):
        arrays = {k: ClimArray(torch.as_tensor(v, device=device),
                               ("time", "cell"), {"time": t}, {"units": "K"},
                               k) for k, v in data.items()}
        return QuantileDeltaMapping.train(
            arrays["ref"], arrays["hist"], group=Grouper("time.dayofyear", 31),
            nquantiles=50, kind="+")

    counts = (winquantile.launches, winquantile.global_launches)
    got = train(cuda)
    torch.cuda.synchronize()
    assert (winquantile.launches, winquantile.global_launches) == (
        counts[0] + 2, counts[1] + 2)
    ref = train("cpu")
    # the kernel's quantiles are the twin's value for value; the factors
    # go through the same torch ops on both devices (1e-6, SURVEY §6)
    _close(got.ds["hist_q"], ref.ds["hist_q"])
    np.testing.assert_allclose(got.ds["af"].cpu().numpy(),
                               ref.ds["af"].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("years, cells", [(30, 64), (300, 3)])
def test_dqm_trains_on_the_kernel_and_matches_the_twin(cuda, years, cells):
    """DQM's train runs winquantile twice on the card (ref and the scaled
    hist; w31 x 300 years takes the global-scratch instance) and agrees
    with the CPU twins; its adjust agrees too."""
    from xclim_tpu_torch.core.dataarray import ClimArray
    from xclim_tpu_torch.sdba import DetrendedQuantileMapping, Grouper

    t = date_range("1701-01-01", periods=years * 365, calendar="noleap")
    rng = np.random.default_rng(years)
    data = {k: rng.normal(mu, 5.0, (len(t), cells)).astype(np.float32)
            for k, mu in (("ref", 285.0), ("hist", 287.0), ("sim", 289.0))}
    data["sim"] += (0.03 * np.arange(len(t)) / 365).astype(np.float32)[:, None]
    data["hist"][rng.random(data["hist"].shape) < 0.05] = np.nan

    def run(device):
        arrays = {k: ClimArray(torch.as_tensor(v, device=device),
                               ("time", "cell"), {"time": t}, {"units": "K"},
                               k) for k, v in data.items()}
        adj = DetrendedQuantileMapping.train(
            arrays["ref"], arrays["hist"], group=Grouper("time.dayofyear", 31),
            nquantiles=50, kind="+")
        return adj, adj.adjust(arrays["sim"])

    shared = winquantile.window_in_shared(31, years)
    counts = (winquantile.launches, winquantile.global_launches,
              winquantile.twin_calls)
    got, out = run(cuda)
    torch.cuda.synchronize()
    assert (winquantile.launches, winquantile.global_launches,
            winquantile.twin_calls) == (
        counts[0] + 2, counts[1] + (0 if shared else 2), counts[2])
    ref, ref_out = run("cpu")
    # scaling is a difference of ~290 K window means summed in another
    # order on the two devices (1e-6 of each, absolute); hist_q (the
    # kernel's quantiles of hist + scaling, value for value the twin's on
    # one input) and af carry that difference; scen as
    # tests/test_torch_sdba_methods.py bounds DQM
    for k in ("scaling", "hist_q", "af"):
        np.testing.assert_allclose(got.ds[k].cpu().numpy(),
                                   ref.ds[k].numpy(), rtol=0, atol=6e-4)
    np.testing.assert_allclose(out.data.cpu().numpy(), ref_out.data.numpy(),
                               rtol=2e-5, atol=0)


def _cases(n_doy, Y, C, seed, kind):
    """(n_doy, Y, C) slices for the sliding kernel: lane 0 all NaN, lane 1
    one valid sample in the whole series, lane 2 one valid sample per
    slice, the rest 10 % missing; ``kind`` adds heavy ties (values rounded
    to 0.5 K), +-inf samples, or a doy 366 that only the leap years have
    (as tests/test_torch_winquantile.py builds them)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (n_doy, Y, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, :, 0] = np.nan
    keep = x[n_doy // 2, 0, 1]
    x[:, :, 1] = np.nan
    x[n_doy // 2, 0, 1] = keep
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


SLIDE_CASES = [
    (365, 30, 1, "normal"), (365, 30, 5, "normal"), (365, 30, 31, "normal"),
    (365, 30, 61, "normal"), (365, 1, 31, "normal"), (365, 2, 31, "normal"),
    (365, 60, 31, "normal"), (360, 30, 31, "normal"),
    (366, 30, 31, "sparse366"), (366, 8, 5, "sparse366"),
    (365, 30, 31, "ties"), (365, 30, 61, "ties"), (365, 30, 31, "inf"),
    (365, 2, 1, "inf"), (7, 3, 9, "normal"), (5, 4, 5, "ties")]


# every path of the sliding kernel (window 1; register sort at the chunk
# starts up to 1024 samples; shared-memory sort above) under three plans:
# as shipped (many chunks at 67 cells), one chunk per doy (every window
# sorted in full, nothing slides), and one chunk per cell group (each
# block slides through every doy)
@pytest.mark.parametrize("plan", ["shipped", "chunk_per_doy", "one_chunk"])
@pytest.mark.parametrize("n_doy,Y,window,kind", SLIDE_CASES)
def test_winquantile_sliding_cases_value_equal(cuda, monkeypatch, n_doy, Y,
                                               window, kind, plan):
    target = {"shipped": None, "chunk_per_doy": 1 << 30, "one_chunk": 1}
    if target[plan] is not None:
        monkeypatch.setattr(winquantile, "TARGET_BLOCKS", target[plan])
        monkeypatch.setattr(winquantile, "TARGET_BLOCKS_SMEM", target[plan])
    x = torch.as_tensor(_cases(n_doy, Y, 67, seed=n_doy * Y + window,
                               kind=kind), device=cuda)
    before = winquantile.launches
    got = winquantile.doy_window_quantiles(x, Q, window)
    torch.cuda.synchronize()
    assert winquantile.launches == before + 1
    _value_equal(got, winquantile.doy_window_quantiles_plain(x, Q, window))


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("n_doy,Y,window,kind", [
    (365, 30, 31, "normal"), (365, 30, 61, "ties"), (365, 30, 1, "inf"),
    (366, 30, 5, "sparse366")])
def test_winquantile_stages_match_their_plain_expressions(cuda, stage, n_doy,
                                                          Y, window, kind):
    x = torch.as_tensor(_cases(n_doy, Y, 1000, seed=stage, kind=kind),
                        device=cuda)
    before = winquantile.stage_launches
    got = winquantile.doy_window_stage(x, Q, window, stage)
    torch.cuda.synchronize()
    assert winquantile.stage_launches == before + 1
    _value_equal(got, winquantile.stage_plain(x, Q, window, stage))


@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("n_doy,Y,C,nanfrac", [
    (365, 30, 300, 0.0), (366, 30, 300, 0.2), (5, 64, 70, 0.1),
    (7, 1, 33, 0.0), (12, 13, 3, 0.5)])
def test_qdmadjust_kernel_matches_twin(cuda, kind, n_doy, Y, C, nanfrac):
    rng = np.random.default_rng(n_doy * Y + C)
    xd = torch.as_tensor(_slices(n_doy, Y, C, seed=C, nanfrac=nanfrac),
                         device=cuda)
    af = torch.as_tensor(np.sort(rng.normal(0.0, 2.0, (n_doy, len(Q), C)),
                                 axis=1).astype(np.float32), device=cuda)
    before = qdmadjust.launches
    got = qdmadjust.qdm_adjust_doy(xd, af, Q, kind)
    torch.cuda.synchronize()
    assert qdmadjust.launches == before + 1
    _close(got, qdmadjust.qdm_adjust_doy_plain(xd, af, Q, kind))


def _qdm_slices(n_doy, Y, C, seed):
    """(n_doy, Y, C) K-scale slices: lane 0 all NaN, lane 1 one valid
    slot, lane 2 ties (0.5 K steps), lane 3 one full tie run, lane 4 +-inf
    slots, the rest 10 % missing."""
    rng = np.random.default_rng(seed)
    x = rng.normal(289.0, 6.0, (n_doy, Y, C)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, :, 0] = np.nan
    x[:, 1:, 1] = np.nan
    x[:, :, 2] = np.round(x[:, :, 2] * 2.0) / 2.0
    x[:, :, 3] = x[:, :1, 3]
    x[:, ::3, 4] = np.inf
    x[:, 1::3, 4] = -np.inf
    return x


def _qdm_nodes(nq):
    """nq non-decreasing nodes in [0, 1], with repeated nodes above 2."""
    if nq == 2:
        return np.asarray([0.1, 0.9], np.float32)
    q = np.sort(np.round(np.linspace(0.0, 1.0, nq) * (nq // 2)) / (nq // 2))
    return q.astype(np.float32)


# Y over the five register widths (8, 16, 32 slots a thread a cell; 48
# and 64 four threads a cell); 2 and 52 nodes stage the factor tile in
# shared memory, 500 read it from global memory
@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("nq", [2, 52, 500])
@pytest.mark.parametrize("Y", [1, 7, 12, 30, 33, 48, 64])
def test_qdmadjust_widths_and_factor_routes(cuda, Y, nq, kind):
    q = _qdm_nodes(nq)
    xd = torch.as_tensor(_qdm_slices(9, Y, 133, seed=Y * nq), device=cuda)
    rng = np.random.default_rng(nq)
    af = np.sort(rng.normal(0.0, 2.0, (9, nq, 133)), axis=1)
    af = torch.as_tensor((1.0 + 0.01 * af if kind == "*" else af)
                         .astype(np.float32), device=cuda)
    counts = (qdmadjust.launches, qdmadjust.af_shared_launches,
              qdmadjust.af_global_launches)
    got = qdmadjust.qdm_adjust_doy(xd, af, q, kind)
    torch.cuda.synchronize()
    shared = nq < 500
    assert qdmadjust.af_in_shared(nq, Y) == shared
    assert (qdmadjust.launches, qdmadjust.af_shared_launches,
            qdmadjust.af_global_launches) == (
        counts[0] + 1, counts[1] + shared, counts[2] + (not shared))
    _value_equal(got, qdmadjust.qdm_adjust_doy_plain(xd, af, q, kind))


@pytest.mark.parametrize("calendar", ["noleap", "standard", "360_day"])
@pytest.mark.parametrize("kind", ["+", "*"])
def test_qdmadjust_series_matches_twin(cuda, calendar, kind):
    from xclim_tpu_torch.sdba import Grouper

    t = date_range("1981-01-01", periods=7 * 365 + 2, calendar=calendar)
    table = Grouper("time.dayofyear").device_adjust_table(t, cuda)[0]
    rng = np.random.default_rng(len(t))
    x = rng.normal(289.0, 6.0, (len(t), 70)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 0] = np.nan
    x[:, 1] = np.round(x[:, 1])
    xf = torch.as_tensor(x, device=cuda)
    af = np.sort(rng.normal(0.0, 2.0, (table.shape[0], len(Q), 70)), axis=1)
    af = torch.as_tensor((1.0 + 0.01 * af if kind == "*" else af)
                         .astype(np.float32), device=cuda)
    before = qdmadjust.launches
    got = qdmadjust.qdm_adjust_series(xf, table, af, Q, kind)
    torch.cuda.synchronize()
    assert qdmadjust.launches == before + 1
    _value_equal(got, qdmadjust.qdm_adjust_series_plain(xf, table, af, Q,
                                                        kind))
    # the series entry is the doy entry between a gather and a scatter
    flat_pos = Grouper("time.dayofyear").device_adjust_table(t, cuda)[2]
    xd = torch.where(table[..., None] >= 0, xf[table.clamp(min=0)],
                     torch.nan)
    _value_equal(got, qdmadjust.qdm_adjust_doy(xd, af, Q, kind).reshape(
        -1, 70)[flat_pos])


def test_qdm_adjust_on_the_card_reads_through_the_table(cuda, monkeypatch):
    from xclim_tpu_torch.core.dataarray import ClimArray
    from xclim_tpu_torch.sdba import Grouper, QuantileDeltaMapping
    from xclim_tpu_torch.sdba import adjustment

    t = date_range("1981-01-01", periods=6 * 365, calendar="noleap")
    rng = np.random.default_rng(6)
    arrays = {k: ClimArray(torch.as_tensor(rng.normal(mu, 5.0, (len(t), 9))
                                           .astype(np.float32), device=cuda),
                           ("time", "cell"), {"time": t}, {"units": "K"}, k)
              for k, mu in (("ref", 285.0), ("hist", 287.0), ("sim", 289.0))}
    adj = QuantileDeltaMapping.train(arrays["ref"], arrays["hist"],
                                     group=Grouper("time.dayofyear", 31),
                                     nquantiles=50)
    gathers = []
    monkeypatch.setattr(adjustment, "gather_groups",
                        lambda *a: gathers.append(a))
    counts = (qdmadjust.launches, qdmadjust.twin_calls)
    out = adj.adjust(arrays["sim"])
    torch.cuda.synchronize()
    assert (qdmadjust.launches, qdmadjust.twin_calls) == (counts[0] + 1,
                                                          counts[1])
    assert gathers == []
    assert out.data.device.type == "cuda"
    assert bool(torch.isfinite(out.data).all())


def test_qdmadjust_rejects_too_many_years(cuda):
    xd = torch.zeros(3, qdmadjust.MAX_Y + 1, 4, device=cuda)
    af = torch.zeros(3, len(Q), 4, device=cuda)
    with pytest.raises(ValueError, match="year slots"):
        qdmadjust.qdm_adjust_doy(xd, af, Q)


def _segred_series(T, C, seed):
    """(T, C) K-scale values: lanes c % 4 == 0 fully valid, 1 partly
    missing (15 %), 2 all missing, 3 valid but for an all-NaN February."""
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (T, C)).astype(np.float32)
    lane = np.arange(C) % 4
    x[(rng.random((T, C)) < 0.15) & (lane == 1)] = np.nan
    x[:, lane == 2] = np.nan
    x[31:59, lane == 3] = np.nan
    return x


def _segred_close(got, exp, op):
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    if op in ("count", "min", "max"):
        np.testing.assert_array_equal(got, exp)         # bit-equal
    else:
        # both round one float64 sum to float32 (1e-6, SURVEY §6)
        np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("cal", ["noleap", "360_day"])
@pytest.mark.parametrize("freq", ["MS", "YS", "QS-DEC", "D"])
@pytest.mark.parametrize("op", sorted(segred.SUPPORTED_OPS))
def test_segred_kernel_matches_twin(cuda, op, freq, cal):
    T = 730 if cal == "noleap" else 720
    spec = resample_segments(date_range("2000-01-01", periods=T, calendar=cal),
                             freq)
    x = torch.as_tensor(_segred_series(T, 1030, seed=T), device=cuda)
    before = segred.launches
    got = segred.segment_reduce_onepass(x, spec.starts, spec.counts, op)
    torch.cuda.synchronize()
    assert segred.launches == before + 1
    _segred_close(got, segred.segment_reduce_onepass_plain(
        x, spec.starts, spec.counts, op), op)


def test_segred_kernel_many_segments(cuda):
    # more segments than one launch's grid.y (65535) takes
    T = 70001
    x = torch.as_tensor(_segred_series(T, 3, seed=1), device=cuda)
    starts, counts = np.arange(T), np.ones(T, dtype=np.int64)
    counts[-1] = 0
    got = segred.segment_reduce_onepass(x, starts, counts, "mean")
    exp = torch.where(torch.arange(T, device=cuda)[:, None] < T - 1, x,
                      torch.nan)
    _segred_close(got, exp, "mean")


def test_segred_kernel_uneven_bounds(cuda):
    x = torch.as_tensor(_segred_series(50, 257, seed=2), device=cuda)
    starts, counts = [0, 3, 3, 10, 49], [3, 0, 7, 1, 1]
    for op in sorted(segred.SUPPORTED_OPS):
        got = segred.segment_reduce_onepass(x, starts, counts, op)
        _segred_close(got, segred.segment_reduce_onepass_plain(
            x, starts, counts, op), op)


def _spell_series(T, C, seed):
    """(T, C) AR(1) K-scale values (runs above a high threshold exist):
    lanes c % 4 == 0 fully valid, 1 partly missing (15 %), 2 all missing,
    3 fully above the threshold (one run per segment)."""
    rng = np.random.default_rng(seed)
    e = rng.normal(0.0, 1.0, (T, C))
    ar = np.zeros((T, C))
    for t in range(1, T):
        ar[t] = 0.8 * ar[t - 1] + 0.6 * e[t]
    x = (290.0 + 5.0 * ar).astype(np.float32)
    lane = np.arange(C) % 4
    x[(rng.random((T, C)) < 0.15) & (lane == 1)] = np.nan
    x[:, lane == 2] = np.nan
    x[:, lane == 3] = 400.0
    return x


def _spells_equal(got, exp):
    # integer counts in float32: bit-equal
    for g, e, name in zip(got, exp, ("cnt", "wrc", "wre", "lng")):
        np.testing.assert_array_equal(g.cpu().numpy(), e.cpu().numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("cal", ["noleap", "360_day"])
@pytest.mark.parametrize("freq", ["MS", "YS", "QS-DEC"])
@pytest.mark.parametrize("op", sorted(spells.OPS))
@pytest.mark.parametrize("window", [1, 3, 6])
def test_spells_kernel_matches_twin(cuda, op, window, freq, cal):
    T = 1095 if cal == "noleap" else 1080
    spec = resample_segments(date_range("2000-01-01", periods=T, calendar=cal),
                             freq)
    x = torch.as_tensor(_spell_series(T, 1030, seed=T + window), device=cuda)
    thresh = 293.0 if op in (">", ">=") else 287.0
    before = spells.launches
    got = spells.spell_stats(x, spec.starts, spec.counts, window, op, thresh)
    torch.cuda.synchronize()
    assert spells.launches == before + 1
    _spells_equal(got, spells.spell_stats_plain(x, spec.starts, spec.counts,
                                                window, op, thresh))


@pytest.mark.parametrize("window", [1, 6])
def test_spells_kernel_bool_condition_in_batch_layout(cuda, window):
    # the bootstrap's condition: logical (time, lat, lon, replacement),
    # replacement-major in memory; read in place with its batch stride
    T = 730
    spec = resample_segments(date_range("1981-01-01", periods=T,
                                        calendar="noleap"), "YS")
    x = torch.as_tensor(_spell_series(T, 7 * 9, seed=3), device=cuda)
    x = x.reshape(T, 7, 9, 1)
    th = torch.as_tensor(np.random.default_rng(4).normal(
        292.0, 2.0, (5, T, 7, 9)).astype(np.float32), device=cuda)
    cond = x > th.permute(1, 2, 3, 0)
    assert not cond.is_contiguous()
    got = spells.spell_stats(cond, spec.starts, spec.counts, window)
    _spells_equal(got, spells.spell_stats_plain(cond, spec.starts,
                                                spec.counts, window))
    assert got[0].shape == (2, 7, 9, 5)


def test_spells_kernel_uneven_bounds_and_nan_thresholds(cuda):
    x = torch.as_tensor(_spell_series(50, 257, seed=5), device=cuda)
    starts, counts = [0, 3, 3, 10, 49], [3, 0, 7, 1, 1]
    # a NaN threshold holds nowhere: every count is 0
    for op in sorted(spells.OPS):
        for thresh in (290.0, float("nan")):
            got = spells.spell_stats(x, starts, counts, 2, op, thresh)
            _spells_equal(got, spells.spell_stats_plain(x, starts, counts, 2,
                                                        op, thresh))


def _edge_segments(kind, T):
    if kind == "whole":
        return [0], [T]
    if kind == "day":
        return list(range(T)), [1] * T
    spec = resample_segments(date_range("1981-01-01", periods=T,
                                        calendar="noleap"), "YS")
    return spec.starts, spec.counts


# one segment over the whole series, one-day segments and YS periods,
# windows longer than a segment, and cell counts that take 4 or 1 cells a
# thread (1030 and 1001 are no multiple of 4; a condition with one-day
# segments at 1000 and 4096 cells takes 4)
@pytest.mark.parametrize("kind", ["whole", "day", "YS"])
@pytest.mark.parametrize("window", [1, 3, 400])
@pytest.mark.parametrize("cells", [1001, 1000, 1030, 4096])
@pytest.mark.parametrize("cond", [False, True])
def test_spells_kernel_edge_segments(cuda, kind, window, cells, cond):
    T = 730
    x = torch.as_tensor(_spell_series(T, cells, seed=cells + window),
                        device=cuda)
    starts, counts = _edge_segments(kind, T)
    arg, op, thresh = (x > 293.0, None, None) if cond else (x, ">", 293.0)
    got = spells.spell_stats(arg, starts, counts, window, op, thresh)
    torch.cuda.synchronize()
    _spells_equal(got, spells.spell_stats_plain(arg, starts, counts, window,
                                                op, thresh))


# the bootstrap's replacement-major condition at each width the kernel
# picks: 4 cells a thread with one-day segments (5 x 730 x 256 threads),
# one with YS (5 x 2 x 1024, too few for 4)
@pytest.mark.parametrize("kind", ["day", "YS"])
@pytest.mark.parametrize("window", [1, 6])
def test_spells_kernel_widths_in_batch_layout(cuda, kind, window):
    T = 730
    starts, counts = _edge_segments(kind, T)
    x = torch.as_tensor(_spell_series(T, 1024, seed=11), device=cuda)
    th = torch.as_tensor(np.random.default_rng(12).normal(
        292.0, 2.0, (5, T, 1024)).astype(np.float32), device=cuda)
    cond = x[:, :, None] > th.permute(1, 2, 0)
    assert not cond.is_contiguous()
    before = spells.launches
    got = spells.spell_stats(cond, starts, counts, window)
    torch.cuda.synchronize()
    assert spells.launches == before + 1
    _spells_equal(got, spells.spell_stats_plain(cond, starts, counts,
                                                window))


@pytest.mark.parametrize("window", [1, 6, 100])
def test_spells_kernel_time_split_in_batch_layout(cuda, window):
    # one segment over the series, batched: cut into parts in time, joined
    T = 730
    x = torch.as_tensor(_spell_series(T, 63, seed=13), device=cuda)
    th = torch.as_tensor(np.random.default_rng(14).normal(
        292.0, 2.0, (5, T, 63)).astype(np.float32), device=cuda)
    cond = x[:, :, None] > th.permute(1, 2, 0)
    assert spells.time_parts(5, 1, 63, [T]) > 1
    got = spells.spell_stats(cond, [0], [T], window)
    torch.cuda.synchronize()
    _spells_equal(got, spells.spell_stats_plain(cond, [0], [T], window))


def _axis_samples(M, axis, seed, nanfrac):
    """(M, 7, 300) K-scale samples moved so the M lie on `axis`, with
    all-NaN, single-valid and tie columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (M, 7, 300)).astype(np.float32)
    x[rng.random(x.shape) < nanfrac] = np.nan
    x[:, 0, 0] = np.nan
    x[1:, 0, 1] = np.nan
    x[::2, 0, 2] = x[0, 0, 2]
    x[:, 1, 3] = np.round(x[:, 1, 3])
    return np.moveaxis(x, 0, axis).copy()


AXQ = np.asarray([0.0, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0], np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1 / 3, 1 / 3),
                                        (0.0, 0.0)])
@pytest.mark.parametrize("M,nanfrac", [(1, 0.0), (2, 0.1), (3, 0.5),
                                       (13, 0.2), (30, 0.0), (30, 0.3),
                                       (32, 0.1), (33, 0.05), (64, 0.4)])
def test_axisquantile_kernel_matches_twin(cuda, M, nanfrac, alpha, beta,
                                          axis):
    x = torch.as_tensor(_axis_samples(M, axis, M * 10 + axis, nanfrac),
                        device=cuda)
    before = axisquantile.launches
    got = axisquantile.axis_quantile_small(x, AXQ, axis, alpha, beta)
    torch.cuda.synchronize()
    assert axisquantile.launches == before + 1
    _value_equal(got, axisquantile.axis_quantile_small_plain(x, AXQ, axis,
                                                             alpha, beta))


def test_axisquantile_dispatch_on_the_card(cuda):
    x = torch.as_tensor(_axis_samples(30, 0, 1, 0.1), device=cuda)
    launches, twins = axisquantile.launches, axisquantile.twin_calls
    got = nan_quantile(x, AXQ, axis=0)
    assert axisquantile.launches == launches + 1
    _value_equal(got, axisquantile.axis_quantile_small_plain(x, AXQ, 0))
    # any number of nodes goes to the kernel
    q = np.linspace(0.0, 1.0, 200, dtype=np.float32)
    _value_equal(nan_quantile(x, q, axis=0),
                 axisquantile.axis_quantile_small_plain(x, q, 0))
    assert axisquantile.launches == launches + 2
    # M = 65 and float64 take the plain path; no call counts as a twin call
    nan_quantile(torch.zeros(65, 9, device=cuda), AXQ, axis=0)
    nan_quantile(x.double(), AXQ, axis=0)
    assert axisquantile.launches == launches + 2
    assert axisquantile.twin_calls == twins


def test_axisquantile_non_contiguous_and_many_nodes(cuda):
    x = torch.as_tensor(_axis_samples(30, 2, 5, 0.2), device=cuda)
    xt = x.transpose(0, 1)
    assert not xt.is_contiguous()
    q = np.linspace(0.0, 1.0, 200, dtype=np.float32)
    _value_equal(axisquantile.axis_quantile_small(xt, q, 2),
                 axisquantile.axis_quantile_small_plain(xt, q, 2))


# post 1, 3, 5, 4099 and 4 (shorter than a tile) load by each thread's own
# loads, 256, 1000 and 4100 through the shared-memory ring (1000 and 4100:
# a partial last tile of each p)
@pytest.mark.parametrize("nq", [1, 200])
@pytest.mark.parametrize("post", [1, 3, 5, 4099, 4, 256, 1000, 4100])
@pytest.mark.parametrize("M", [1, 2, 13, 30, 33, 64])
def test_axisquantile_load_routes(cuda, M, post, nq):
    rng = np.random.default_rng(M * post + nq)
    pre = 3 if post < 4096 else 2
    x = rng.normal(285.0, 5.0, (pre, M, post)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = np.nan
    x[:, :, 0] = np.nan
    if post > 2:
        x[:, 1:, 1] = np.nan
        x[:, ::2, 2] = np.round(x[:, ::2, 2])
    x = torch.as_tensor(x, device=cuda)
    q = np.linspace(0.0, 1.0, nq, dtype=np.float32) if nq > 1 else \
        np.asarray([0.37], np.float32)
    staged = axisquantile.staged_route(post, x.data_ptr())
    assert staged == (post % 4 == 0 and post >= 256)
    counts = (axisquantile.staged_launches, axisquantile.direct_launches)
    got = axisquantile.axis_quantile_small(x, q, 1)
    torch.cuda.synchronize()
    assert (axisquantile.staged_launches, axisquantile.direct_launches) == (
        counts[0] + staged, counts[1] + (not staged))
    _value_equal(got, axisquantile.axis_quantile_small_plain(x, q, 1))


def test_axisquantile_unaligned_start_loads_directly(cuda):
    x = torch.as_tensor(_axis_samples(30, 0, 7, 0.1), device=cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xu = buf[1:].view(x.shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    before = axisquantile.direct_launches
    got = axisquantile.axis_quantile_small(xu, AXQ, 0)
    torch.cuda.synchronize()
    assert axisquantile.direct_launches == before + 1
    _value_equal(got, axisquantile.axis_quantile_small(x, AXQ, 0))
    _value_equal(got, axisquantile.axis_quantile_small_plain(x, AXQ, 0))


def test_axisquantile_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="1 to 64"):
        axisquantile.axis_quantile_small(torch.zeros(65, 4, device=cuda),
                                         AXQ, 0)
    with pytest.raises(ValueError, match="no axisquantile kernel"):
        axisquantile.axis_quantile_small(torch.zeros(30, 4), AXQ, 0)


def _temps(device, cal, seed, mu):
    """(time, 16, 33) tasmax-like K over four years of `cal` with NaN holes,
    as a ClimArray on `device`."""
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("2001-01-01", periods={"360_day": 1440}.get(cal, 1460),
                   calendar=cal)
    rng = np.random.default_rng(seed)
    x = rng.normal(mu, 6.0, (len(t), 16, 33)).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    x[:, 3, 4] = np.nan
    return ClimArray(torch.as_tensor(x, device=device), ("time", "lat", "lon"),
                     {"time": t}, {"units": "K"}, "tas")


def _card_vs_cpu(fn, *arrays, **kw):
    """fn on the card and on CPU copies: outputs value-equal, the card run
    launching spells or segred and calling no twin."""
    before = {m: (m.launches, m.twin_calls) for m in (spells, segred)}
    got = fn(*arrays, **kw)
    torch.cuda.synchronize()
    launched = sum(m.launches - before[m][0] for m in (spells, segred))
    assert launched >= 1
    assert all(m.twin_calls == before[m][1] for m in (spells, segred))
    exp = fn(*(a.to("cpu") for a in arrays), **kw)
    _value_equal(got.data, exp.data)
    # the history line carries the call's timestamp
    assert got.dims == exp.dims and got.attrs.keys() == exp.attrs.keys()
    assert all(got.attrs[k] == exp.attrs[k] for k in exp.attrs
               if k != "history")
    return got


@pytest.mark.parametrize("cal", ["noleap", "360_day"])
@pytest.mark.parametrize("freq", ["YS", "MS"])
def test_heat_wave_and_hot_spell_frequency_on_the_card(cuda, freq, cal):
    from xclim_tpu_torch import indices

    tn, tx = _temps(cuda, cal, 1, 288.0), _temps(cuda, cal, 2, 298.0)
    before = spells.launches
    _card_vs_cpu(indices.heat_wave_frequency, tn, tx, thresh_tasmin="15 degC",
                 thresh_tasmax="25 degC", window=2, freq=freq)
    assert spells.launches == before + 1
    _card_vs_cpu(indices.hot_spell_frequency, tx, thresh="26 degC", window=3,
                 freq=freq)
    _card_vs_cpu(indices.heat_wave_max_length, tn, tx, thresh_tasmin="15 degC",
                 thresh_tasmax="25 degC", freq=freq)


@pytest.mark.parametrize("cal", ["noleap", "360_day"])
@pytest.mark.parametrize("freq", ["YS", "MS"])
@pytest.mark.parametrize("op", [">", ">=", "<", "<="])
def test_threshold_count_on_the_card(cuda, op, freq, cal):
    from xclim_tpu_torch.indices import generic

    tx = _temps(cuda, cal, 3, 298.0)
    before = spells.launches, segred.launches
    got = _card_vs_cpu(generic.threshold_count, tx, op=op,
                       threshold="25 degC", freq=freq)
    # the chosen route: one spells launch, no segred
    assert (spells.launches, segred.launches) == (before[0] + 1, before[1])
    plain = generic.compare(tx, op, 298.15).astype(torch.float32) \
        .resample(freq).sum()
    _value_equal(got.data, plain.data)


def test_threshold_indicators_on_the_card(cuda):
    from xclim_tpu_torch.indicators import atmos

    tx = _temps(cuda, "noleap", 4, 298.0)
    tx.attrs.update(standard_name="air_temperature",
                    cell_methods="time: maximum")
    tn = _temps(cuda, "noleap", 5, 288.0)
    tn.attrs.update(standard_name="air_temperature",
                    cell_methods="time: minimum")
    _card_vs_cpu(atmos.tx_days_above, tx, thresh="25 degC", freq="YS")
    _card_vs_cpu(atmos.heat_wave_frequency, tn, tx, thresh_tasmin="15 degC",
                 thresh_tasmax="25 degC", freq="YS")
    _card_vs_cpu(atmos.maximum_consecutive_frost_days, tn, thresh="12 degC")
    _card_vs_cpu(atmos.growing_season_length, tn)
    _card_vs_cpu(atmos.frost_free_season_start, tn, thresh="12 degC")


def _card_vs_cpu_close(fn, *arrays, rtol=1e-6, atol=0.0, **kw):
    """fn on the card and on CPU copies: the same NaN pattern, values
    within rtol (a float32 transcendental on the card may round one ulp
    another way than on the CPU), no twin called on the card."""
    before = {m: m.twin_calls for m in (spells, segred)}
    got = fn(*arrays, **kw)
    torch.cuda.synchronize()
    assert all(m.twin_calls == before[m] for m in (spells, segred))
    exp = fn(*(a.to("cpu") for a in arrays), **kw)
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    for g, e in zip(got, exp):
        assert g.data.device.type == "cuda" and g.dims == e.dims
        gn, en = g.data.cpu().numpy(), e.data.numpy()
        np.testing.assert_array_equal(np.isnan(gn), np.isnan(en))
        np.testing.assert_allclose(gn, en, rtol=rtol, atol=atol,
                                   equal_nan=True)
    return got


def _precip(device, seed):
    from xclim_tpu_torch.core.dataarray import ClimArray

    t = date_range("2001-01-01", periods=1460, calendar="noleap")
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(3e-5, 3e-5, (len(t), 16, 33))).astype(np.float32)
    x[rng.random(x.shape) < 0.5] = 0.0
    x[rng.random(x.shape) < 0.01] = np.nan
    return ClimArray(torch.as_tensor(x, device=device), ("time", "lat", "lon"),
                     {"time": t, "lat": np.linspace(-60, 60, 16)},
                     {"units": "kg m-2 s-1",
                      "standard_name": "precipitation_flux"}, "pr")


def test_fused_chain_on_the_card(cuda):
    """bench.py's 10-indicator chain through the registry on the card:
    segred and spells launched, no twin, outputs equal to the CPU run's
    (counts and run lengths value-equal, sums within 1e-6)."""
    from xclim_tpu_torch import climjit_chain
    from xclim_tpu_torch.core.indicator import registry

    arrays = {"tas": _temps(cuda, "noleap", 6, 285.0),
              "tasmax": _temps(cuda, "noleap", 7, 291.0),
              "tasmin": _temps(cuda, "noleap", 8, 279.0),
              "pr": _precip(cuda, 9)}
    for k, cm in (("tas", "mean"), ("tasmax", "maximum"),
                  ("tasmin", "minimum")):
        arrays[k].name = k
        arrays[k].attrs.update(standard_name="air_temperature",
                               cell_methods=f"time: {cm}")
    chain = [("TG_MEAN", "tas", {"freq": "MS"}),
             ("TX_DAYS_ABOVE", "tasmax", {"thresh": "25 degC"}),
             ("FROST_DAYS", "tasmin", {}), ("ICE_DAYS", "tasmax", {}),
             ("GROWING_DEGREE_DAYS", "tas", {"thresh": "4 degC"}),
             ("HEATING_DEGREE_DAYS", "tas", {"thresh": "17 degC"}),
             ("COOLING_DEGREE_DAYS", "tas", {"thresh": "18 degC"}),
             ("HEAT_WAVE_INDEX", "tasmax", {}), ("CDD", "pr", {}),
             ("PRCPTOT", "pr", {})]

    def run(arr):
        steps = [lambda a=arr, k=k, v=v, kw=kw: registry[k](a[v], **kw)
                 for k, v, kw in chain]
        return climjit_chain(steps)()

    before = segred.launches, spells.launches
    got = run(arrays)
    torch.cuda.synchronize()
    assert segred.launches > before[0] and spells.launches > before[1]
    exp = run({k: a.to("cpu") for k, a in arrays.items()})
    for (key, _, _), g, e in zip(chain, got, exp):
        if key in ("TG_MEAN", "GROWING_DEGREE_DAYS", "HEATING_DEGREE_DAYS",
                   "COOLING_DEGREE_DAYS", "PRCPTOT"):
            _close(g.data, e.data)
        else:
            _value_equal(g.data, e.data)


@pytest.mark.parametrize("name", ["cdd", "cwd", "wetdays", "dry_days",
                                  "precip_accumulation", "dry_spell_frequency",
                                  "wet_spell_max_length", "daily_pr_intensity",
                                  "max_n_day_precipitation_amount", "api"])
def test_precip_indicators_on_the_card(cuda, name):
    from xclim_tpu_torch.indicators import atmos

    _card_vs_cpu_close(getattr(atmos, name), _precip(cuda, 10))


def test_index_breadth_on_the_card(cuda):
    """The new index modules on the card against their CPU runs: phase
    splits and degree days exact, transcendental physics (e_sat, PET)
    within 1e-5 relative (CUDA's float32 exp, log and pow round an ulp
    another way than the CPU's)."""
    from xclim_tpu_torch import indices

    pr = _precip(cuda, 11)
    tas = _temps(cuda, "noleap", 12, 283.0)
    tn = _temps(cuda, "noleap", 13, 277.0)
    tx = _temps(cuda, "noleap", 14, 289.0)
    for a in (tas, tn, tx):
        a.coords["lat"] = np.linspace(-60, 60, 16)
    _card_vs_cpu_close(indices.precip_accumulation, pr, tas, phase="solid")
    _card_vs_cpu_close(lambda p, t: indices.liquid_precip_ratio(
        p, tas=t, freq="YS"), pr, tas)
    _card_vs_cpu_close(indices.huglin_index, tas, tx)
    _card_vs_cpu_close(indices.biologically_effective_degree_days, tn, tx)
    _card_vs_cpu_close(indices.prcptot_wetdry_quarter, pr)
    _card_vs_cpu_close(indices.antecedent_precipitation_index, pr)
    _card_vs_cpu_close(indices.rain_season, pr)
    _card_vs_cpu_close(indices.potential_evapotranspiration, tn, tx, tas,
                       method="TW48", rtol=1e-5, atol=1e-12)
    _card_vs_cpu_close(indices.saturation_vapor_pressure, tas, rtol=1e-5)
    hourly = indices.helpers.make_hourly_temperature(
        tn.isel(time=slice(0, 60)), tx.isel(time=slice(0, 60)))
    _card_vs_cpu_close(indices.chill_units, hourly)
    # the dynamic model banks a portion only where E reaches 1, and an E
    # within rounding of 1 may bank on one device and not the other: each
    # device is held to a float64 replay that follows its own decisions;
    # a NaN hour ends the carry, so the NaN-filled series runs it through
    filled = hourly.copy(data=torch.nan_to_num(hourly.data, nan=281.0))
    for arr in (hourly, filled):
        check_chill_portions(arr)
        check_chill_portions(arr.to("cpu"))


# ------------------------------------------------------------- bootstrap

BOOT_MODES = ["plain", "nans", "ties", "dead_lane", "nan_edges"]


def _boot_samples(n_doy, Y, w, C, mode, seed):
    """(n_doy, Y, w, C) in-base samples in the modes of
    tests/test_torch_bootstrap.py."""
    rng = np.random.default_rng(seed)
    D = rng.normal(285.0, 5.0, (n_doy, Y, w, C)).astype(np.float32)
    if mode == "nans":
        D[rng.random(D.shape) < 0.2] = np.nan
    elif mode == "ties":
        D = np.round(D)
    elif mode == "dead_lane":
        D[..., 0] = np.nan
        D[:, 1:, :, 1] = np.nan              # one valid year
    elif mode == "nan_edges":
        D[0, 0, :2] = np.nan                 # the window before the start
        D[-1, -1, 3:] = np.nan               # ... and after the end
    return D


def _boot_check(cuda, n_doy, Y, w, C, mode, q, years=None, seed=0):
    """The kernel (both forms) against the twin on CPU copies, value for
    value, for the removed years ``years`` (default all); returns the
    counters' moves."""
    D = torch.as_tensor(_boot_samples(n_doy, Y, w, C, mode, seed),
                        device=cuda)
    K = bootstrap.topk_capacity(Y * w, w, q)
    tabs = bootstrap.topk_rank_tables(D.reshape(n_doy, Y * w, C),
                                      np.arange(Y).repeat(w), K)
    ctabs = [t.cpu() for t in tabs]
    names = ("launches", "shared_launches", "global_launches", "twin_calls")
    before = [getattr(bootstrap, n) for n in names]
    for b in range(Y) if years is None else years:
        got = bootstrap.merge_rank_replaced_year_quantile(
            *tabs, None, None, b, q, samples=D)
        A_b = D[:, b].movedim(-1, -2)
        A_o = torch.stack([D[:, o].movedim(-1, -2) for o in range(Y)
                           if o != b])
        got_p = bootstrap.merge_rank_replaced_year_quantile(*tabs, A_b, A_o,
                                                            b, q)
        torch.cuda.synchronize()
        exp = bootstrap.merge_rank_replaced_year_quantile_plain(
            *ctabs, A_b.cpu(), A_o.cpu(), b, q)
        _value_equal(got, exp)
        _value_equal(got_p, exp)
    return dict(zip(names, (getattr(bootstrap, n) - v
                            for n, v in zip(names, before)))), K


@pytest.mark.parametrize("mode", BOOT_MODES)
@pytest.mark.parametrize("q", [0.9, 0.1, 0.75, 0.25])
def test_bootstrap_kernel_matches_twin(cuda, q, mode):
    moved, K = _boot_check(cuda, 3, 6, 5, 200, mode, q,
                           seed=int(q * 100) + len(mode))
    assert bootstrap.table_in_shared(K, 5)
    assert moved == {"launches": 12, "shared_launches": 12,
                     "global_launches": 0, "twin_calls": 0}


# w 17 is past the registers of the shared-memory instance: global scratch
@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7, 17])
@pytest.mark.parametrize("q", [0.9, 0.1, 0.75, 0.25])
def test_bootstrap_kernel_windows(cuda, q, w):
    moved, K = _boot_check(cuda, 2, 6, w, 75, "nans", q, seed=w)
    shared = bootstrap.table_in_shared(K, w)
    assert shared == (w <= bootstrap.MAX_REGISTER_W)
    assert moved == {"launches": 12, "shared_launches": 12 * shared,
                     "global_launches": 12 * (not shared), "twin_calls": 0}


# 30 years at w 31 make a table past shared memory (K 127 at q 0.9)
@pytest.mark.parametrize("Y,w", [(2, 5), (6, 5), (30, 5), (30, 31)])
@pytest.mark.parametrize("q", [0.9, 0.1, 0.75, 0.25])
def test_bootstrap_kernel_years(cuda, q, Y, w):
    moved, K = _boot_check(cuda, 2, Y, w, 130, "nan_edges", q,
                           years=sorted({0, Y // 2, Y - 1}), seed=Y + w)
    shared = bootstrap.table_in_shared(K, w)
    n = len({0, Y // 2, Y - 1}) * 2
    assert moved == {"launches": n, "shared_launches": n * shared,
                     "global_launches": n * (not shared), "twin_calls": 0}
    if (Y, w) == (30, 31):
        assert K > bootstrap.MAX_SHARED_K and not shared


def test_bootstrap_kernel_at_the_cells_shape(cuda):
    """365 doys, 30 years, w 5, 4096 cells, q the float32 0.9 that the
    thresholds' attributes hold (K 23): against the twin on the card (its
    ops on CPU copies are those the small cases hold)."""
    n_doy, Y, w, C, q = 365, 30, 5, 4096, float(np.float32(0.9))
    D = torch.as_tensor(_boot_samples(n_doy, Y, w, C, "nan_edges", 7),
                        device=cuda)
    K = bootstrap.topk_capacity(Y * w, w, q)
    assert K == 23
    tabs = bootstrap.topk_rank_tables(D.reshape(n_doy, Y * w, C),
                                      np.arange(Y).repeat(w), K)
    for b in (0, 17, 29):
        got = bootstrap.merge_rank_replaced_year_quantile(
            *tabs, None, None, b, q, samples=D)
        others = torch.as_tensor([o for o in range(Y) if o != b],
                                 device=cuda)
        exp = bootstrap.merge_rank_replaced_year_quantile_plain(
            *tabs, D[:, b].movedim(-1, -2),
            D.index_select(1, others).permute(1, 0, 3, 2), b, q)
        _value_equal(got, exp)


def test_bootstrap_launch_failure_raises(cuda, monkeypatch):
    """A launch the kernel refuses (the shared-memory instance, handed no
    scratch, asked for a 127-slot table and a 31-day window) raises, and no
    twin serves the call."""
    D = torch.as_tensor(_boot_samples(1, 30, 31, 8, "plain", 3), device=cuda)
    K = bootstrap.topk_capacity(30 * 31, 31, 0.9)
    tabs = bootstrap.topk_rank_tables(D.reshape(1, 30 * 31, 8),
                                      np.arange(30).repeat(31), K)
    monkeypatch.setattr(bootstrap, "table_in_shared", lambda K, w: True)
    counts = (bootstrap.launches, bootstrap.twin_calls)
    with pytest.raises(RuntimeError, match="bootstrap kernel launch failed"):
        bootstrap.merge_rank_replaced_year_quantile(*tabs, None, None, 0, 0.9,
                                                    samples=D)
    assert (bootstrap.launches, bootstrap.twin_calls) == counts


def test_bootstrap_kernel_refuses_float64(cuda):
    """The kernel reads float32: float64 values on the card raise before
    any launch (the twin takes them on the CPU)."""
    D = torch.as_tensor(_boot_samples(2, 6, 5, 8, "plain", 4),
                        device=cuda).double()
    tabs = bootstrap.topk_rank_tables(D.reshape(2, 30, 8),
                                      np.arange(6).repeat(5), 12)
    counts = (bootstrap.launches, bootstrap.twin_calls)
    with pytest.raises(TypeError, match="float32 on the card"):
        bootstrap.merge_rank_replaced_year_quantile(*tabs, None, None, 0, 0.9,
                                                    samples=D)
    assert (bootstrap.launches, bootstrap.twin_calls) == counts


def test_bootstrapped_indices_launch_once_a_base_year(cuda):
    """tx90p and WSDI with the bootstrap on the card: one launch an in-base
    year and percentile (4 base years), no twin, and the CPU run's values."""
    from xclim_tpu_torch.core.percentiles import percentile_doy
    from xclim_tpu_torch.indicators import atmos

    tx_cpu = _temps("cpu", "noleap", 21, 289.0)
    # no holes: the indicators' missing-value check would mask every year
    tx_cpu = tx_cpu.copy(data=torch.nan_to_num(tx_cpu.data, nan=289.0))
    # the same thresholds on both devices
    per_cpu = percentile_doy(tx_cpu, 5, 90)

    def run(device):
        tx, per = tx_cpu.to(device), per_cpu.to(device)
        return (atmos.tx90p(tx, tasmax_per=per, freq="YS", bootstrap=True),
                atmos.warm_spell_duration_index(tx, tasmax_per=per, window=3,
                                                freq="YS", bootstrap=True))

    counts = (bootstrap.launches, bootstrap.twin_calls)
    got = run(cuda)
    torch.cuda.synchronize()
    assert (bootstrap.launches, bootstrap.twin_calls) == (counts[0] + 8,
                                                          counts[1])
    for g, e in zip(got, run("cpu")):
        assert not torch.isnan(e.data).all()
        _value_equal(g.data, e.data)
