"""Quantiles over a short axis (at most 64 samples): the ensemble kernel.

Ensemble percentiles reduce over ~30 realizations for every cell and day.
:func:`axis_quantile_small` computes the NaN-skipping Hyndman-Fan quantiles
of :func:`~xclim_tpu_torch.ops.quantile.nan_quantile` over one axis of a
CUDA tensor with the hand-written kernel ``csrc/axisquantile.cu`` (one
thread per column of the (pre, M, post) view, a register sorting network)
and raises if the launch fails; it serves no other device. The kernel
loads its columns by one of two routes, picked by shape
(:func:`staged_route`): through a ring of tiles in shared memory filled by
16-byte asynchronous copies (``post`` a multiple of 4, at least a tile of
:data:`TILE` columns, and a 16-byte aligned start), or by each thread's
own loads (the rest: the last axis, ``post % 4 != 0``, short rows, an
unaligned view).
:func:`~xclim_tpu_torch.ops.quantile.nan_quantile` sends it every CUDA
float32 call with 1 < M <= 64. :func:`axis_quantile_small_plain` is the
plain PyTorch twin: the sort formulation, on any device.

``launches`` counts kernel launches (``staged_launches`` and
``direct_launches`` by route); ``twin_calls`` the calls that
``nan_quantile`` served with the twin because the tensor lay on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.ops.quantile import _node_constants, nan_quantile_plain
from xclim_tpu_torch.utils.profiling import span

__all__ = ["MAX_AXIS", "axis_quantile_small", "axis_quantile_small_plain",
           "staged_route"]

#: kernel launches made by axis_quantile_small
launches = 0
#: of those, the launches by the shared-memory ring route
staged_launches = 0
#: and those by the per-thread load route
direct_launches = 0
#: nan_quantile calls served with the plain twin (CPU tensors)
twin_calls = 0

#: longest reduce axis the kernel sorts in registers
MAX_AXIS = 64
#: columns of one tile of the shared-memory route
TILE = 256


def _q_host(q) -> np.ndarray:
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    return np.asarray(q, dtype=np.float32).reshape(-1)


def staged_route(post: int, data_ptr: int) -> bool:
    """Whether the kernel loads the columns of a (pre, M, post) view that
    starts at ``data_ptr`` through its shared-memory ring: every row of a
    tile is whole 16-byte chunks, and a row fills at least one tile (a
    short row would leave most of a tile's threads idle)."""
    return post % 4 == 0 and post >= TILE and data_ptr % 16 == 0


def axis_quantile_small(x: torch.Tensor, q, axis: int = 0,
                        alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """Quantiles over ``axis`` (1 <= M <= 64 samples) of a CUDA float32
    tensor: shape (nq,) + x.shape without the axis, on x's device, with the
    semantics and the bits of
    :func:`~xclim_tpu_torch.ops.quantile.nan_quantile_plain`."""
    global launches, staged_launches, direct_launches
    with span("op.axisquantile"):
        if x.device.type != "cuda":
            raise ValueError(f"no axisquantile kernel for device {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"x must be float32, got {x.dtype}")
        ax = axis % x.ndim
        M = x.shape[ax]
        if not 1 <= M <= MAX_AXIS:
            raise ValueError(f"axis of {M} samples: the kernel takes 1 to "
                             f"{MAX_AXIS}")
        qv, coff = _node_constants(_q_host(q), alpha, beta)
        nq = len(qv)
        xc = x.contiguous()
        pre = int(np.prod(x.shape[:ax], dtype=np.int64))
        post = int(np.prod(x.shape[ax + 1:], dtype=np.int64))
        rest = x.shape[:ax] + x.shape[ax + 1:]
        out = torch.empty((nq, pre * post), dtype=torch.float32, device=x.device)
        if out.numel() == 0:
            return out.reshape((nq,) + rest)
        nodes = _build.device_copy(np.concatenate([qv, coff]).tobytes(),
                                   torch.float32, x.device)
        staged = staged_route(post, xc.data_ptr())
        # x, out, nodes, M, nq, pre, post, staged
        _build.launch("axisquantile", "xtt_axisquantile", "pppiiqqi", x.device,
                      xc.data_ptr(), out.data_ptr(), nodes.data_ptr(), M, nq,
                      pre, post, int(staged))
        launches += 1
        if staged:
            staged_launches += 1
        else:
            direct_launches += 1
        return out.reshape((nq,) + rest)


def axis_quantile_small_plain(x: torch.Tensor, q, axis: int = 0,
                              alpha: float = 1.0,
                              beta: float = 1.0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, on x's device: the sort
    formulation of :func:`~xclim_tpu_torch.ops.quantile.nan_quantile_plain`
    with the same host-rounded nodes."""
    return nan_quantile_plain(x, _q_host(q), axis, alpha, beta)
