"""Day-of-year quantiles of a daily series, read through its percentile
table.

``percentile_doy`` (``core/percentiles.py``) takes, for each day of the
year and cell, quantiles of the samples its table names
(:func:`~xclim_tpu_torch.core.calendar.percentile_doy_table`: a centred
window of ``window`` days around that day in every year, -1 where a sample
is missing). :func:`doy_quantile` computes them from the series itself.

On a CUDA float32 series whose table rows fit the kernel's shared memory
(:func:`kernel_takes`) it makes one launch of the hand-written kernel
``csrc/doyquantile.cu``: a thread a cell keeps its cell's samples in
shared memory, replaces each year's leaving sample by its entering one
where the host's :func:`slide_flags` allow, and finds each quantile's two
order statistics in one pass around the doy before's value, so no (n_doy,
N, cells) sample tensor is made; a failed launch raises. Every other input (CPU tensors, float64,
longer rows) runs the plain twin :func:`doy_quantile_plain`, the gather of
every sample (:func:`gather_samples`) and
:func:`~xclim_tpu_torch.ops.quantile.nan_quantile`. The kernel gives the
sort formulation's values (``nan_quantile_plain``), value for value.

``launches`` and ``twin_calls`` (CPU tensors) count the calls each path
served; each launch also counts ``doyquantile_launches`` to the innermost
span.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.ops.quantile import _node_constants, nan_quantile
from xclim_tpu_torch.utils.profiling import count, span

__all__ = ["doy_quantile", "doy_quantile_plain", "gather_samples",
           "kernel_takes", "on_kernel", "slide_flags"]

#: calls of doy_quantile that ran on the card
launches = 0
#: calls served with the plain twin on CPU tensors
twin_calls = 0

#: cells of one block of the kernel (a thread each; csrc kCells)
CELLS = 32
#: shared memory a block may use after the opt-in (bytes)
SMEM_BYTES = 227 * 1024
#: consecutive doys a block of the kernel walks
DOYS = 16


def kernel_takes(n_samples: int) -> bool:
    """Whether the kernel holds a table row of ``n_samples`` positions: each
    thread's samples in shared memory (up to 1816)."""
    return 0 < n_samples and n_samples * CELLS * 4 <= SMEM_BYTES


def on_kernel(series, n_samples: int) -> bool:
    """Whether :func:`doy_quantile` launches the kernel for ``series`` and
    a table of ``n_samples`` positions a row: a CUDA float32 series and
    rows the kernel holds."""
    return (series.device.type == "cuda" and series.dtype == torch.float32
            and kernel_takes(n_samples))


def slide_flags(table, window: int) -> np.ndarray:
    """(n_doy,) bool, from the host's (n_doy, years * window) ``table``:
    True where row d is row d - 1 moved on by one day in every year (each
    year's window less its first position, and one new last position), so
    that the kernel replaces one sample a year instead of loading the row
    anew. Row 0 never is. A window of 1 makes every later row a slide of
    all its samples."""
    t = np.asarray(table)
    if t.ndim != 2 or window < 1 or t.shape[1] % window:
        raise ValueError(f"a (n_doy, years * {window}) table is needed, got "
                         f"shape {t.shape}")
    w = t.reshape(t.shape[0], -1, window)
    out = np.zeros(t.shape[0], dtype=bool)
    out[1:] = (w[1:, :, :-1] == w[:-1, :, 1:]).all(axis=(1, 2))
    return out


def gather_samples(series: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The (n_doy, N, ...) samples ``series[table]`` of a (T, ...) series,
    NaN where the table reads -1."""
    with span("percentiles.gather"):
        t = table.to(device=series.device, dtype=torch.int64)
        g = series[t.clamp(min=0)]
        ok = (t >= 0).reshape(t.shape + (1,) * (g.ndim - 2))
        return torch.where(ok, g, torch.nan)


def doy_quantile(series: torch.Tensor, table: torch.Tensor, q,
                 alpha: float = 1.0, beta: float = 1.0, window: int = 1,
                 slides=None, quantile=nan_quantile) -> torch.Tensor:
    """Quantiles ``q`` of each table row's samples, for every cell.

    series: (T, cells...), time first; table: (n_doy, N) integer indices
    into T on the series' device, -1 where a sample is missing (a NaN value
    is missing too); q: 1-D quantiles in [0, 1] (a sequence, numpy array or
    tensor); alpha, beta: the Hyndman-Fan parameters of
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile`. ``window`` divides
    N into years of ``window`` days and ``slides`` is
    :func:`slide_flags` of the table (computed here when None, from a host
    copy of a table on the card); neither changes the values, only what the
    kernel loads anew. Returns (Q, n_doy, cells...) on the series' device:
    ``nan_quantile(series[table], q, axis=1, alpha, beta)`` with the missing
    samples NaN, NaN where a row has no valid sample. ``quantile`` is what
    the twin applies to the gathered samples (a function of
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile`'s arguments).
    """
    global twin_calls
    with span("op.doyquantile"):
        if table.ndim != 2 or table.dtype.is_floating_point \
                or table.dtype == torch.bool:
            raise TypeError(f"table must be a 2-D integer tensor, got "
                            f"{table.dtype} of shape {tuple(table.shape)}")
        if table.device != series.device:
            raise ValueError(f"series on {series.device} but table on "
                             f"{table.device}")
        if series.ndim < 1:
            raise ValueError("series needs a time axis")
        if on_kernel(series, table.shape[1]):
            if slides is None:
                slides = slide_flags(table.cpu().numpy(), window)
            return _launch(series, table, q, alpha, beta, window, slides)
        if series.device.type == "cpu":
            twin_calls += 1
        return doy_quantile_plain(series, table, q, alpha, beta, quantile)


def _launch(series, table, q, alpha, beta, window, slides):
    global launches
    n_doy, N = table.shape
    if N % window:
        raise ValueError(f"window {window} does not divide the table's "
                         f"{N} positions")
    slides = np.ascontiguousarray(slides, dtype=np.uint8)
    if slides.shape != (n_doy,):
        raise ValueError(f"slides must be ({n_doy},), got {slides.shape}")
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    qv, cq = _node_constants(q, alpha, beta)
    T, cells = series.shape[0], tuple(series.shape[1:])
    C = int(np.prod(cells, dtype=np.int64))
    device = series.device
    x = series.reshape(T, C).contiguous()
    out = torch.empty((len(qv), n_doy, C), dtype=torch.float32, device=device)
    if out.numel():
        tab = table.to(torch.int32).contiguous()
        flags = _build.device_copy(slides.tobytes(), torch.uint8, device)
        consts = _build.device_copy(np.concatenate([qv, cq]).tobytes(),
                                    torch.float32, device)
        _build.launch("doyquantile", "xtt_doyquantile", "pppppqiiiii",
                      device, x.data_ptr(), tab.data_ptr(), flags.data_ptr(),
                      consts.data_ptr(), out.data_ptr(), C, n_doy, N, window,
                      len(qv), DOYS)
        launches += 1
        count("doyquantile_launches")
    return out.reshape((len(qv), n_doy) + cells)


def doy_quantile_plain(series: torch.Tensor, table: torch.Tensor, q,
                       alpha: float = 1.0, beta: float = 1.0,
                       quantile=nan_quantile) -> torch.Tensor:
    """Plain PyTorch twin of :func:`doy_quantile`, on the series' device:
    :func:`gather_samples`, then ``quantile`` (by default
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile`) over the samples."""
    return quantile(gather_samples(series, table), q, axis=1, alpha=alpha,
                    beta=beta)
