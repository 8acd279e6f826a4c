"""Windowed day-of-year group quantiles: the sdba training kernel.

The quantile-mapping trainers need, for every day-of-year group g, the
quantiles of ALL samples whose doy falls in a ±half window around g (window
31 in the north-star config). :func:`doy_window_quantiles` computes them
from the (n_doy, Y, C) doy slices:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/winquantile.cu`` (one block per doy and up to 8 cells; each
  window bitonic-sorted in a warp's registers, or in shared memory when it
  holds more than 1024 samples) and raises if the launch fails;
* on a CPU tensor it runs :func:`doy_window_quantiles_plain`, the plain
  PyTorch twin: the windowed gather plus the sort quantile of
  :func:`~xclim_tpu_torch.ops.quantile.nan_quantile_plain`, chunked over
  cells (never the dispatcher, so the twin stays plain on the card).

``launches`` and ``twin_calls`` count the calls each path served.
"""

from __future__ import annotations

import ctypes

import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.ops.quantile import _node_constants, nan_quantile_plain

__all__ = ["doy_window_quantiles", "doy_window_quantiles_plain"]

#: kernel launches made by doy_window_quantiles
launches = 0
#: calls doy_window_quantiles served with the plain twin (CPU tensors)
twin_calls = 0

#: largest padded window (window * Y rounded up to a power of two) the
#: kernel sorts within 48 KB of shared memory per block
MAX_P2 = 8192

_SLAB_BYTES = 1 << 30


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _check(xg: torch.Tensor, window: int):
    if xg.dtype != torch.float32:
        raise TypeError(f"xg must be float32, got {xg.dtype}")
    if xg.ndim != 3:
        raise ValueError(f"xg must be (n_doy, Y, C), got shape {tuple(xg.shape)}")
    if window % 2 != 1 or window < 1:
        raise ValueError("window must be a positive odd number")


def doy_window_quantiles(xg: torch.Tensor, q, window: int, alpha: float = 1.0,
                         beta: float = 1.0) -> torch.Tensor:
    """Quantiles of each wrapped ±(window//2)-doy group of slices.

    xg: (n_doy, Y, C) float32, NaN where missing (slot y of doy d = d-th doy
    of the y-th year, or NaN). q: (nq,) quantile nodes in [0, 1].
    Returns (n_doy, nq, C) on xg's device, with the Hyndman-Fan alpha/beta
    semantics of :func:`~xclim_tpu_torch.ops.quantile.nan_quantile` (no
    valid samples -> NaN).
    """
    global launches, twin_calls
    _check(xg, window)
    if xg.device.type == "cpu":
        twin_calls += 1
        return doy_window_quantiles_plain(xg, q, window, alpha, beta)
    if xg.device.type != "cuda":
        raise ValueError(f"no winquantile kernel for device {xg.device}")

    n_doy, Y, C = xg.shape
    P2 = max(2, _pow2(window * Y))
    if P2 > MAX_P2:
        raise ValueError(f"window*Y = {window * Y} exceeds the kernel's "
                         f"{MAX_P2}-sample sort")
    CT = min(8, MAX_P2 // P2)
    qv, coff = _node_constants(q, alpha, beta)
    nq = len(qv)
    x = xg.contiguous()
    qv_d = torch.as_tensor(qv, device=x.device)
    co_d = torch.as_tensor(coff, device=x.device)
    out = torch.empty((n_doy, nq, C), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = _function()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), qv_d.data_ptr(),
                 co_d.data_ptr(), n_doy, Y, C, window, nq, P2, CT, stream)
    if err != 0:
        raise RuntimeError(f"winquantile kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _function():
    lib = _build.load("winquantile")
    fn = lib.xtt_winquantile
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def doy_window_quantiles_plain(xg: torch.Tensor, q, window: int,
                               alpha: float = 1.0,
                               beta: float = 1.0) -> torch.Tensor:
    """Plain PyTorch twin: windowed gather + sort quantile, on xg's device.

    The windowed gather holds every sample ``window`` times (22 GB at 30
    years x 16384 cells), so cells go through in slabs whose gathered block
    stays under ~1 GB; the sort underneath allocates a few times that.
    """
    _check(xg, window)
    n_doy, Y, C = xg.shape
    half = window // 2
    rows = (torch.arange(n_doy)[:, None]
            + torch.arange(-half, half + 1)[None, :]) % n_doy
    rows = rows.reshape(-1).to(xg.device)
    qv = torch.as_tensor(q, dtype=torch.float32, device=xg.device)
    out = torch.empty((n_doy, len(qv), C), dtype=torch.float32,
                      device=xg.device)
    slab = max(1, min(C, _SLAB_BYTES // max(1, n_doy * window * Y * 4)))
    for c0 in range(0, C, slab):
        part = xg[:, :, c0:c0 + slab]
        g = part[rows].reshape(n_doy, window * Y, part.shape[-1])
        res = nan_quantile_plain(g, qv, axis=1, alpha=alpha, beta=beta)
        out[:, :, c0:c0 + slab] = res.movedim(0, 1)
    return out
