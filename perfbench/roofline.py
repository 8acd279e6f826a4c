"""Peaks of one NVIDIA H100 SXM and the least time a kernel's work can take.

The bound counts each input byte read once and each output byte written
once, whatever the kernel reads again, and the operations the inputs need;
the least time is the larger of bytes over the memory rate and operations
over the float32 rate (NVIDIA's data sheet, dense, at the 700 W limit).
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12   # H100 SXM: device memory rate
F32_OPS_S = 67e12       # H100 SXM: float32 rate outside the tensor cores


def bound(nbytes: float, ops: float) -> dict:
    """{"bound_ms", "bound_by"}: the least milliseconds the card could take
    for ``nbytes`` moved and ``ops`` float32 operations, and which of the
    two sets it ("bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = ops / F32_OPS_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


def share(calls) -> float | None:
    """Percent of the device time of an op entry's ``calls`` ({"ms",
    "bound_ms"} each) that their least time takes; None without calls."""
    if not calls:
        return None
    return (100.0 * sum(c["bound_ms"] for c in calls)
            / sum(c["ms"] for c in calls))
