"""Fused QDM adjust: per-doy rank + adjustment-factor interpolation.

QDM's adjust step (reference: xsdba.QuantileDeltaMapping.adjust, Cannon et
al. 2015) ranks every simulated value within its (windowless) day-of-year
group and interpolates the trained adjustment factors at that empirical
rank. :func:`qdm_adjust_doy` does it on the (n_doy, Y, C) doy slices:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/qdmadjust.cu`` (one block per doy and 32 cells) and raises if the
  launch fails;
* on a CPU tensor it runs :func:`qdm_adjust_doy_plain`, the plain PyTorch
  twin: :func:`~xclim_tpu_torch.sdba.utils.grouped_rank` plus
  :func:`~xclim_tpu_torch.sdba.utils.interp_hat_nodes`.

``launches`` and ``twin_calls`` count the calls each path served.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from xclim_tpu_torch.ops import _build

__all__ = ["qdm_adjust_doy", "qdm_adjust_doy_plain", "MAX_Y"]

#: kernel launches made by qdm_adjust_doy
launches = 0
#: calls qdm_adjust_doy served with the plain twin (CPU tensors)
twin_calls = 0

#: most year slots per doy group the kernel ranks (its shared-memory tile)
MAX_Y = 64


def _check(xd: torch.Tensor, af: torch.Tensor, q: np.ndarray, kind: str):
    if xd.dtype != torch.float32 or af.dtype != torch.float32:
        raise TypeError(f"xd and af must be float32, got {xd.dtype}, {af.dtype}")
    if xd.ndim != 3 or af.ndim != 3:
        raise ValueError("xd must be (n_doy, Y, C) and af (n_doy, nq, C)")
    n_doy, Y, C = xd.shape
    if af.shape != (n_doy, len(q), C):
        raise ValueError(f"af shape {tuple(af.shape)} does not match "
                         f"{(n_doy, len(q), C)}")
    if len(q) < 2:
        raise ValueError("at least two quantile nodes are needed")
    if kind not in ("+", "*"):
        raise ValueError(f"kind must be '+' or '*', got {kind!r}")
    if af.device != xd.device:
        raise ValueError(f"xd on {xd.device} but af on {af.device}")


def qdm_adjust_doy(xd: torch.Tensor, af: torch.Tensor, q,
                   kind: str = "+") -> torch.Tensor:
    """Adjusted values for doy-sliced sim data.

    xd: (n_doy, Y, C) float32 sim gathered to per-doy year slots (NaN
    padded); af: (n_doy, nq, C) trained adjustment factors; q: (nq,) nodes.
    Returns (n_doy, Y, C) on xd's device: af interpolated at each value's
    empirical within-group rank (linear, constant extrapolation) and applied
    with ``kind``.
    """
    global launches, twin_calls
    q = np.asarray(q, dtype=np.float32).reshape(-1)
    _check(xd, af, q, kind)
    if xd.device.type == "cpu":
        twin_calls += 1
        return qdm_adjust_doy_plain(xd, af, q, kind)
    if xd.device.type != "cuda":
        raise ValueError(f"no qdmadjust kernel for device {xd.device}")

    n_doy, Y, C = xd.shape
    if Y > MAX_Y:
        raise ValueError(f"too many year slots for the adjust kernel: {Y}")
    x = xd.contiguous()
    a = af.contiguous()
    q_d = torch.as_tensor(q, device=x.device)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _function()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), a.data_ptr(), q_d.data_ptr(), out.data_ptr(),
                 n_doy, Y, C, len(q), int(kind == "*"), stream)
    if err != 0:
        raise RuntimeError(f"qdmadjust kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def _function():
    lib = _build.load("qdmadjust")
    fn = lib.xtt_qdmadjust
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def qdm_adjust_doy_plain(xd: torch.Tensor, af: torch.Tensor, q,
                         kind: str = "+") -> torch.Tensor:
    """Plain PyTorch twin: grouped_rank + interp_hat_nodes, on xd's device."""
    from xclim_tpu_torch.sdba.utils import grouped_rank, interp_hat_nodes

    nvalid = (~torch.isnan(xd)).sum(dim=1)
    tau = grouped_rank(xd, nvalid)
    af_v = interp_hat_nodes(tau, q, af)
    return xd + af_v if kind == "+" else xd * af_v
