"""The betainc op on the CPU: its argument checks, its twin route, the twin
against the ensembles' ``_betainc`` body it replaced, value for value, and
its counter. The kernel against the twin is in
``tests/test_torch_kernels_cuda.py``; the twin against JAX's betainc in
``tests/test_torch_ensembles.py``."""

import numpy as np
import pytest
import torch

from xclim_tpu_torch.ensembles import _robustness
from xclim_tpu_torch.ops import betainc
from xclim_tpu_torch.utils.profiling import tracing

_HALF_EPS = float(np.finfo(np.float32).eps) / 2.0
_VERY_SMALL = float(np.finfo(np.float32).tiny) * 2.0


def _parent_numerator(it, a, b, x):
    if it == 1:
        return torch.ones_like(x)
    m = (it - 1) // 2
    if it % 2 == 0:
        if m == 0:
            return -(a + b) * x / (a + 1.0)
        return -(a + m) * (a + b + m) * x / ((a + 2.0 * m) * (a + 2.0 * m + 1.0))
    return m * (b - m) * x / ((a + 2.0 * m - 1.0) * (a + 2.0 * m))


def _parent_betainc(a, b, x):
    """``ensembles._robustness._betainc`` before the op: the eager loop."""
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
    a, b = (torch.where(converges_rapidly, a, b),
            torch.where(converges_rapidly, b, a))
    x = torch.where(converges_rapidly, x, 1.0 - x)
    h = torch.full_like(x, _HALF_EPS)
    c = h
    d = torch.zeros_like(x)
    for it in range(1, 200):
        num = _parent_numerator(it, a, b, x)
        c = 1.0 + num / c
        c = torch.where(c.abs() < _HALF_EPS, _HALF_EPS, c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < _HALF_EPS, _HALF_EPS, d)
        d = torch.reciprocal(d)
        delta = c * d
        h = h * delta
        if not bool(((delta - 1.0).abs() >= _HALF_EPS).any()):
            break
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


def _cases():
    """(a, b, x) as numpy float32: the grids and draws of
    ``test_torch_ensembles.py``, a Welch-like non-integer df and the
    special cases."""
    rng = np.random.default_rng(23)
    out = {}
    A, X = np.meshgrid(np.linspace(0.5, 100.0, 40, dtype=np.float32),
                       np.linspace(0.001, 0.999, 50, dtype=np.float32))
    for b in (0.5, 1.0, 3.0, 40.0):
        out[f"grid b={b}"] = (A, np.full_like(A, b), X)
    t = np.abs(rng.standard_t(10, 3000)).astype(np.float32) * 2
    for name, df in (("ttest", rng.integers(1, 200, 3000)),
                     ("welch", rng.uniform(1.0, 200.0, 3000))):
        df = df.astype(np.float32)
        out[name] = (df / 2, np.full_like(df, 0.5), df / (df + t * t))
    a, b = (rng.uniform(0.05, 60.0, 3000).astype(np.float32) for _ in "ab")
    out["random"] = (a, b, rng.uniform(0.0, 1.0, 3000).astype(np.float32))
    out["special"] = tuple(np.asarray(v, np.float32) for v in (
        [0, 1, 0, 2, np.inf, 1, 2, -1, 2, np.nan, 0, 2, 1e-39, 3, np.inf],
        [1, 0, 0, np.inf, 2, 2, 2, 2, -1, 1, 1, 2, 2, np.nan, np.inf],
        [0.5, 0.5, 0.5, 0.3, 0.3, 0.0, 1.0, 0.5, 0.5, 0.5, 0.0, 1.5, 0.5,
         0.5, 0.5]))
    return out


def _bit_equal(got, exp):
    assert got.shape == exp.shape and got.dtype == exp.dtype == torch.float32
    assert torch.equal(torch.isnan(got), torch.isnan(exp))
    ok = ~torch.isnan(exp)
    assert torch.equal(got[ok], exp[ok])


@pytest.mark.parametrize("case", sorted(_cases()))
def test_the_cpu_runs_the_twin_value_for_value(case):
    a, b, x = (torch.as_tensor(v) for v in _cases()[case])
    counts = (betainc.launches, betainc.twin_calls)
    got = betainc.betainc(a, b, x)
    assert (betainc.launches, betainc.twin_calls) == (counts[0],
                                                      counts[1] + 1)
    exp = _parent_betainc(a, b, x)
    _bit_equal(got, exp)
    _bit_equal(betainc.betainc_plain(a, b, x), exp)
    _bit_equal(_robustness._betainc(a, b, x), exp)


@pytest.mark.parametrize("where", ["a", "b", "x"])
def test_a_python_number_broadcasts_against_tensors(where):
    rng = np.random.default_rng(5)
    args = {"a": torch.as_tensor(rng.uniform(1, 90, (3, 1)).astype(np.float32)),
            "b": torch.as_tensor(rng.uniform(0.2, 5, (1, 4)).astype(np.float32)),
            "x": torch.as_tensor(rng.uniform(0, 1, (3, 4)).astype(np.float32))}
    number = {"a": 12.5, "b": 0.5, "x": 0.25}[where]
    got = betainc.betainc(**dict(args, **{where: number}))
    full = torch.full((3, 4), number, dtype=torch.float32)
    assert got.shape == (3, 4)
    _bit_equal(got, _parent_betainc(**dict(args, **{where: full})))


def test_float64_tensors_are_taken_as_float32():
    a, b, x = (torch.as_tensor(v) for v in _cases()["random"])
    _bit_equal(betainc.betainc(a.double(), b.double(), x.double()),
               _parent_betainc(a, b, x))


@pytest.mark.parametrize("args,error,match", [
    ((torch.ones(3, dtype=torch.int32), 0.5, torch.rand(3)), TypeError,
     "floating-point"),
    ((torch.ones(3), 0.5, torch.rand(3) > 0.5), TypeError, "floating-point"),
    ((2.0, 0.5, 0.3), TypeError, "at least one tensor"),
    ((torch.ones(3), "0.5", torch.rand(3)), TypeError, "Python numbers"),
    ((torch.ones(3), True, torch.rand(3)), TypeError, "Python numbers"),
    ((torch.ones(3), 0.5, torch.rand(3, device="meta")), ValueError,
     "arguments on"),
])
def test_the_entry_refuses_what_it_does_not_take(args, error, match):
    counts = (betainc.launches, betainc.twin_calls)
    with pytest.raises(error, match=match):
        betainc.betainc(*args)
    assert (betainc.launches, betainc.twin_calls) == counts


def test_a_device_without_the_kernel_raises():
    a = torch.ones(3, device="meta")
    counts = (betainc.launches, betainc.twin_calls)
    with pytest.raises(ValueError, match="no betainc kernel"):
        betainc.betainc(a, 0.5, a)
    assert (betainc.launches, betainc.twin_calls) == counts


def test_the_twin_counts_a_term_a_step(monkeypatch):
    steps = []
    numerator = betainc._betainc_numerator

    def counted(it, a, b, x):
        steps.append(it)
        return numerator(it, a, b, x)

    monkeypatch.setattr(betainc, "_betainc_numerator", counted)
    a, b, x = (torch.as_tensor(v) for v in _cases()["ttest"])
    with tracing() as tr:
        betainc.betainc(a, b, x)
    (op,) = tr.spans
    assert op["name"] == "op.betainc"
    assert steps == list(range(1, len(steps) + 1)) and len(steps) > 1
    assert op["betainc_terms"] == tr.counters["betainc_terms"] == len(steps)


@pytest.mark.parametrize("iterations", [1, 2, 5, 30])
def test_iterations_bound_the_terms(iterations):
    a, b, x = (torch.as_tensor(v) for v in _cases()["ttest"])
    with tracing() as tr:
        cut = betainc.betainc(a, b, x, iterations)
    assert tr.counters["betainc_terms"] == iterations - 1
    full = betainc.betainc(a, b, x)
    assert torch.equal(torch.isnan(cut), torch.isnan(full))
    assert not torch.equal(torch.nan_to_num(cut), torch.nan_to_num(full))


def test_the_ensembles_hand_their_iterations_to_the_op(monkeypatch):
    a, b, x = (torch.as_tensor(v) for v in _cases()["ttest"])
    monkeypatch.setattr(_robustness, "_BETAINC_ITERATIONS", 5)
    with tracing() as tr:
        got = _robustness._betainc(a, b, x)
    assert tr.counters["betainc_terms"] == 4
    _bit_equal(got, betainc.betainc(a, b, x, 5))


def test_empty_and_zero_dimensional_shapes():
    assert betainc.betainc(torch.ones(0, 3), 0.5, 0.5).shape == (0, 3)
    got = betainc.betainc(torch.tensor(3.0), 0.5, 0.2)
    assert got.shape == () and got.dtype == torch.float32
    _bit_equal(got, _parent_betainc(torch.tensor(3.0), 0.5, 0.2))


def _first_convergence_steps(a, b, x, iterations=betainc.ITERATIONS):
    """Each element's continued-fraction terms, replayed alone in numpy
    float32 scalars, one rounding an operation, in the order of
    ``csrc/betainc.cu``: the term at which its delta first meets the
    tolerance, iterations - 1 where none does, 0 for a special case."""
    f = np.float32
    out = []
    for a, b, x in zip(*(np.asarray(v, np.float32).ravel() for v in (a, b, x))):
        a_zero = a == 0 or b == np.inf
        b_zero = b == 0 or a == np.inf
        if (np.isnan(a) or np.isnan(b) or np.isnan(x) or a < 0 or b < 0
                or x < 0 or x > 1 or (a_zero and b_zero)
                or (a_zero and x != 0) or (b_zero and x == 1)
                or (b_zero and x != 1) or (a_zero and x == 0)):
            out.append(0)
            continue
        if not x < f(f(a + f(1)) / f(f(a + b) + f(2))):
            a, b, x = b, a, f(f(1) - x)
        c, d, terms = f(_HALF_EPS), f(0), 0
        for it in range(1, iterations):
            m = (it - 1) // 2
            a2m = f(a + f(2 * m))
            if it == 1:
                num = f(1)
            elif it % 2 == 0 and m == 0:
                num = f(f(-f(a + b) * x) / f(a + f(1)))
            elif it % 2 == 0:
                p = f(f(-f(a + f(m)) * f(f(a + b) + f(m))) * x)
                num = f(p / f(a2m * f(a2m + f(1))))
            else:
                p = f(f(f(m) * f(b - f(m))) * x)
                num = f(p / f(f(a2m - f(1)) * a2m))
            c = f(f(1) + f(num / c))
            c = f(_HALF_EPS) if abs(c) < _HALF_EPS else c
            d = f(f(1) + f(num * d))
            d = f(f(1) / (f(_HALF_EPS) if abs(d) < _HALF_EPS else d))
            terms = it
            if abs(f(f(c * d) - f(1))) < _HALF_EPS:
                break
        out.append(terms)
    return np.asarray(out)


def _sampled(n):
    """The elements the counting build counts: those of one block of 256
    in 32."""
    return (np.arange(n) // 256) % 32 == 0


def test_the_sampled_elements_are_every_32nd_block_of_256():
    got = betainc.sampled(20000, "cpu").numpy()
    assert got.dtype == bool and (got == _sampled(20000)).all()
    assert np.flatnonzero(got).tolist() == (
        list(range(256)) + list(range(8192, 8448))
        + list(range(16384, 16640)))


@pytest.mark.parametrize("case", ["grid b=3.0", "ttest", "special"])
def test_the_twin_counts_each_elements_terms(case):
    """While tracing, the twin counts betainc_element_terms (the sum of
    each sampled element's first-convergence step) and betainc_elements
    (the sampled elements), inside op.betainc, as the kernel's counting
    build does; special cases count 0."""
    a, b, x = _cases()[case]
    if case == "ttest":
        a, b, x = (np.tile(v, 4)[:9000] for v in (a, b, x))
    elif case != "special":
        a, b, x = (v.ravel()[:300] for v in (a, b, x))
    keep = _sampled(x.size)
    steps = _first_convergence_steps(*(v[keep] for v in (a, b, x)))
    if case == "special":
        # x at 0 or 1 with a, b finite and positive, and a tiny a, take
        # the fraction
        assert (np.flatnonzero(steps) == [5, 6, 12]).all()
    else:
        assert (steps > 0).all() and steps.max() < betainc.ITERATIONS - 1
    with tracing() as tr:
        betainc.betainc(*(torch.as_tensor(v) for v in (a, b, x)))
    assert tr.counters["betainc_element_terms"] == int(steps.sum())
    assert tr.counters["betainc_elements"] == int(keep.sum()) == len(steps)
    (op,) = tr.spans
    assert op["betainc_element_terms"] == int(steps.sum())


@pytest.mark.parametrize("iterations", [1, 2, 5])
def test_an_element_that_never_converges_counts_every_term(iterations):
    a, b, x = (v[:300] for v in _cases()["ttest"])
    steps = _first_convergence_steps(a[:256], b[:256], x[:256], iterations)
    assert steps.max() == iterations - 1
    if iterations < 3:
        assert (steps == iterations - 1).all()
    with tracing() as tr:
        betainc.betainc(*(torch.as_tensor(v) for v in (a, b, x)), iterations)
    assert tr.counters["betainc_element_terms"] == int(steps.sum())
    assert tr.counters["betainc_elements"] == 256
