"""The regularized incomplete beta function I_x(a, b) in float32.

The ensembles' significance tests (``ensembles/_robustness.py``: the Student
and Welch t-tests, Brown-Forsythe's F test) take their distribution
functions from it; ``torch.special`` has none. Reference:
``jax.scipy.special.betainc`` (``jax._src.lax.special.
regularized_incomplete_beta_impl``, XLA's ``math.cc``): the symmetry swap
where x >= (a+1)/(a+b+2), Lentz's continued fraction from float32 eps/2 as
the small value and the tolerance, at most ``iterations - 1`` terms, the
same special cases (a or b zero or infinite, x at 0 or 1, out-of-domain and
NaN arguments).

On a CUDA tensor :func:`betainc` launches the hand-written kernel
``csrc/betainc.cu``: a thread an element, its continued fraction in
registers, each element leaving the loop at its own convergence; one launch
a call, no host sync, and a failed launch raises. Each launch counts one
``betainc_terms``. On a CPU tensor it runs the plain twin
:func:`betainc_plain`, which steps the whole call's fraction together until
every element has converged, as XLA's while loop does: one
``betainc_terms`` and one host check a step.

While the program traces, the card launches the counting build of the
kernel (build target ``betainc_count``), which adds the sampled
elements' continued-fraction terms and the sampled elements to the
counters ``betainc_element_terms`` and ``betainc_elements``; the twin
counts them too, an element's terms being the step at which its delta
first met the tolerance (``iterations - 1`` if it never did), 0 for a
special case. The sampled elements (:func:`sampled`) are those of one
block of the kernel in :data:`SAMPLE_EVERY`: counting every element's
terms costs the launch ~12 %.

``launches`` and ``twin_calls`` count the calls each path served.
"""

from __future__ import annotations

import numpy as np
import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.utils import profiling
from xclim_tpu_torch.utils.profiling import count, span

__all__ = ["betainc", "betainc_plain", "ITERATIONS"]

#: calls of betainc that ran on the card
launches = 0
#: calls served with the plain twin (CPU tensors)
twin_calls = 0

_F32 = np.finfo(np.float32)
#: the continued fraction's small value and tolerance: float32 eps / 2
_HALF_EPS = float(_F32.eps) / 2.0
#: below this `a`, the prefactor uses a * gamma(a) -> 1
_VERY_SMALL = float(_F32.tiny) * 2.0
#: continued-fraction terms evaluated at most, plus one (XLA's count for
#: float32)
ITERATIONS = 200
#: the counting build's counters, and the twin's, in csrc/betainc.cu's order
COUNTERS = ("betainc_element_terms", "betainc_elements")
#: the counting build counts the elements of one block in this many, a
#: block holding BLOCK consecutive elements (csrc/betainc.cu kSampleEvery,
#: kThreads)
SAMPLE_EVERY = 32
BLOCK = 256


def betainc(a, b, x, iterations: int = ITERATIONS) -> torch.Tensor:
    """I_x(a, b), float32, of the broadcast shape of ``a``, ``b`` and ``x``:
    tensors or Python numbers, at least one a tensor, the tensors of a
    floating dtype (taken as float32) and on one device."""
    global twin_calls
    with span("op.betainc"):
        tensors = [v for v in (a, b, x) if isinstance(v, torch.Tensor)]
        if not tensors:
            raise TypeError("betainc needs at least one tensor argument")
        for v in (a, b, x):
            if isinstance(v, torch.Tensor):
                if not v.dtype.is_floating_point:
                    raise TypeError(f"betainc takes floating-point tensors, "
                                    f"got {v.dtype}")
            elif isinstance(v, bool) or not isinstance(v, (int, float)):
                raise TypeError(f"betainc takes tensors or Python numbers, "
                                f"got {type(v).__name__}")
        device = tensors[0].device
        for t in tensors:
            if t.device != device:
                raise ValueError(f"betainc arguments on {device} and "
                                 f"{t.device}")
        if device.type == "cpu":
            twin_calls += 1
            return betainc_plain(a, b, x, iterations)
        return _launch(a, b, x, device, iterations)


def _operand(v, shape, device):
    """(float32 tensor, step): an operand that is one value after
    broadcasting is read in place (a Python number from a device copy made
    once per value), step 0; any other is the contiguous full-shape
    tensor, step 1."""
    if not isinstance(v, torch.Tensor):
        return _build.device_copy(np.float32(v).tobytes(), torch.float32,
                                  device), 0
    v = v.to(torch.float32)
    if v.numel() == 1:
        return v.reshape(1), 0
    return torch.broadcast_to(v, shape).contiguous(), 1


def _launch(a, b, x, device, iterations):
    global launches
    if device.type != "cuda":
        raise ValueError(f"no betainc kernel for device {device}")
    # numpy's: torch.broadcast_shapes imports sympy on its first call (~4 s)
    shape = np.broadcast_shapes(*(tuple(v.shape) for v in (a, b, x)
                                  if isinstance(v, torch.Tensor)))
    (ta, sa), (tb, sb), (tx, sx) = (_operand(v, shape, device)
                                    for v in (a, b, x))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    args = (ta.data_ptr(), tb.data_ptr(), tx.data_ptr(), out.data_ptr(),
            out.numel(), sa, sb, sx, int(iterations))
    if profiling.active():
        # a pair a sampled block of the launch's grid, each written once
        grid = min(-(-out.numel() // BLOCK), 1 << 30)
        counts = torch.empty((-(-grid // SAMPLE_EVERY), len(COUNTERS)),
                             dtype=torch.int64, device=device)
        _build.launch(*_build.COUNTING["betainc"], device, *args,
                      counts.data_ptr())
        count(COUNTERS, counts)
    else:
        _build.launch("betainc", "xtt_betainc", "ppppqiiii", device, *args)
    launches += 1
    count("betainc_terms")
    return out


def sampled(numel: int, device) -> torch.Tensor:
    """Which of ``numel`` elements (in C order) the counting build counts:
    those of every SAMPLE_EVERY-th block of BLOCK, as a bool tensor."""
    i = torch.arange(numel, device=device)
    return (i // BLOCK) % SAMPLE_EVERY == 0


def _betainc_numerator(it: int, a, b, x):
    """Partial numerator `it` of the continued fraction (DLMF 8.17.23)."""
    if it == 1:
        return torch.ones_like(x)
    m = (it - 1) // 2
    if it % 2 == 0:
        if m == 0:
            return -(a + b) * x / (a + 1.0)
        return -(a + m) * (a + b + m) * x / ((a + 2.0 * m) * (a + 2.0 * m + 1.0))
    return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def betainc_plain(a, b, x, iterations: int = ITERATIONS) -> torch.Tensor:
    """Plain PyTorch twin of :func:`betainc`, on the arguments' device.

    The Lentz-Thompson-Barnett evaluation of
    ``jax._src.lax.special.regularized_incomplete_beta_impl`` (XLA's
    ``math.cc``): the loop runs until every element of the call has
    converged, as XLA's while loop does, with one host check a step. While
    tracing, it also counts :data:`COUNTERS` as the kernel does.
    """
    device = next(v.device for v in (a, b, x) if isinstance(v, torch.Tensor))
    a, b, x = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=torch.float32, device=device)
        for v in (a, b, x)))
    a_is_zero = (a == 0) | (b == torch.inf)
    b_is_zero = (b == 0) | (a == torch.inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = ((a < 0) | (b < 0) | (x < 0) | (x > 1)
                     | (a_is_zero & b_is_zero) | is_nan)

    converges_rapidly = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(converges_rapidly, a, b), torch.where(converges_rapidly, b, a)
    x = torch.where(converges_rapidly, x, 1.0 - x)

    # iteration 0: partial denominator 0 -> the small value
    h = torch.full_like(x, _HALF_EPS)
    c = h
    d = torch.zeros_like(x)
    # each element's terms: the step at which it first converged
    terms = torch.zeros(x.shape, dtype=torch.int64, device=device) \
        if profiling.active() else None
    it = 0
    for it in range(1, iterations):
        count("betainc_terms")
        num = _betainc_numerator(it, a, b, x)
        c = 1.0 + num / c
        c = torch.where(c.abs() < _HALF_EPS, _HALF_EPS, c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < _HALF_EPS, _HALF_EPS, d)
        d = torch.reciprocal(d)
        delta = c * d
        h = h * delta
        going = (delta - 1.0).abs() >= _HALF_EPS
        if terms is not None:
            terms = torch.where((terms == 0) & ~going, it, terms)
        if not bool(going.any()):
            break
    if terms is not None:
        terms = torch.where(terms == 0, it, terms)     # never converged
        special = result_is_zero | result_is_one | result_is_nan
        keep = sampled(x.numel(), device).reshape(x.shape)
        count(COUNTERS[0], (terms * (keep & ~special)).sum())
        count(COUNTERS[1], keep.sum())

    lbeta_ab_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta_ab = torch.lgamma(a) + lbeta_ab_small_a
    factor = torch.where(
        a < _VERY_SMALL,
        torch.exp(torch.log1p(-x) * b - lbeta_ab_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta_ab) / a)
    result = h * factor
    result = torch.where(converges_rapidly, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, torch.nan, result)
