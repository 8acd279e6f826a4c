"""The port's short-axis quantile (the dispatcher of ``ops/quantile.py`` and
the twin of the axisquantile kernel) against the JAX package's routes on the
same numpy inputs.

* Bit-equal to the reference's sorting-network route
  ``small_axis_nan_quantile_network``: both round the same float32 op
  sequence once per step.
* Within rtol 1e-6 of the XLA route ``nan_quantile(..., _no_pallas=True)``
  and of the Pallas kernels in interpret mode: XLA:CPU fuses ``n*q + coff``
  into one FMA, so h (and with it the interpolation weight) can sit an ulp
  away, which moves the result by up to 1 ulp (~1.2e-7 relative here). The
  atol of 1e-6 covers values near 0 (the case ``test_values_near_zero``
  draws), where an ulp of the weight times a gap of order 1 is absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.ops.pallas.axisquantile import axis_quantile_small as j_small
from xclim_tpu.ops.pallas.axisquantile import axis_quantile_small_nd as j_small_nd
from xclim_tpu.ops.quantile import nan_quantile as j_nan_quantile
from xclim_tpu.ops.quantile import small_axis_nan_quantile_network as j_network
from xclim_tpu_torch.ops import axisquantile
from xclim_tpu_torch.ops.quantile import nan_quantile, nan_quantile_plain

Q = np.asarray([0.0, 0.01, 0.1, 0.5, 0.9, 0.99, 1.0], np.float32)
ALPHA_BETA = [(1.0, 1.0), (1.0 / 3.0, 1.0 / 3.0), (0.0, 0.0)]
MS = [2, 3, 13, 30, 32, 64]
RTOL = 1e-6
ATOL = 1e-6


def _data(M, axis, seed, loc=285.0, scale=5.0):
    """(M, 5, 40) moved so the M samples lie on `axis`, with a NaN fraction
    of 0 to 0.5 growing with the seed, all-NaN, single-valid and tie
    columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(loc, scale, (M, 5, 40)).astype(np.float32)
    x[rng.random(x.shape) < (seed % 6) / 10.0] = np.nan
    x[:, 0, 0] = np.nan                         # all missing
    x[1:, 0, 1] = np.nan                        # one valid sample
    x[::2, 0, 2] = x[0, 0, 2]                   # ties
    x[:, 1, 3] = np.round(x[:, 1, 3])
    return np.moveaxis(x, 0, axis).copy()


def _port(x, axis, alpha, beta):
    return nan_quantile(torch.as_tensor(x), Q, axis=axis, alpha=alpha,
                        beta=beta).numpy()


def _close(got, exp):
    assert got.shape == exp.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("alpha,beta", ALPHA_BETA)
@pytest.mark.parametrize("M", MS)
def test_bit_equal_to_network_route(M, alpha, beta, axis):
    x = _data(M, axis, seed=M + axis)
    got = _port(x, axis, alpha, beta)
    net = np.asarray(j_network(jnp.asarray(x), Q, axis, alpha, beta))
    np.testing.assert_array_equal(got, net)
    xla = np.asarray(j_nan_quantile(jnp.asarray(x), Q, axis=axis, alpha=alpha,
                                    beta=beta, _no_pallas=True))
    _close(got, xla)


@pytest.mark.parametrize("alpha,beta", ALPHA_BETA)
@pytest.mark.parametrize("M", MS)
def test_within_1e6_of_pallas_interpret(M, alpha, beta):
    x = _data(M, 0, seed=3 * M)
    got = _port(x, 0, alpha, beta)
    pal = np.asarray(j_small(jnp.asarray(x.reshape(M, -1)), Q, alpha=alpha,
                             beta=beta, interpret=True)).reshape(got.shape)
    _close(got, pal)


# the 3-D Pallas kernel unrolls Batcher's network into one program: XLA
# compiles it in ~8 s at M = 30 and in minutes at M = 64, so it is held
# at the short axes and once at the ensemble's 30
@pytest.mark.parametrize("M,alpha,beta", [
    (2, 1.0, 1.0), (3, 1 / 3, 1 / 3), (13, 0.0, 0.0), (13, 1.0, 1.0),
    (30, 1.0, 1.0)])
def test_within_1e6_of_pallas_nd_interpret(M, alpha, beta):
    x = _data(M, 0, seed=5 * M)
    got = _port(x, 0, alpha, beta)
    pal = np.asarray(j_small_nd(jnp.asarray(x), Q, alpha=alpha, beta=beta,
                                interpret=True))
    _close(got, pal)


def test_values_near_zero():
    x = _data(30, 1, seed=11, loc=0.0, scale=1.0)
    got = _port(x, 1, 1.0, 1.0)
    np.testing.assert_array_equal(
        got, np.asarray(j_network(jnp.asarray(x), Q, 1, 1.0, 1.0)))
    _close(got, np.asarray(j_nan_quantile(jnp.asarray(x), Q, axis=1,
                                          _no_pallas=True)))


@pytest.mark.parametrize("nq", [3, 200])
def test_cpu_tensor_counts_a_twin_call(nq):
    # any number of nodes is in the kernel's domain
    x = torch.as_tensor(_data(30, 0, seed=1))
    q = np.linspace(0.0, 1.0, nq, dtype=np.float32)
    launches, twins = axisquantile.launches, axisquantile.twin_calls
    got = nan_quantile(x, q, axis=0)
    assert axisquantile.twin_calls == twins + 1
    assert axisquantile.launches == launches
    np.testing.assert_array_equal(got.numpy(),
                                  nan_quantile_plain(x, q, axis=0).numpy())
    np.testing.assert_array_equal(
        got.numpy(), axisquantile.axis_quantile_small_plain(x, q, 0).numpy())


@pytest.mark.parametrize("shape,dtype,nq", [
    ((1, 40), torch.float32, 3),                     # M = 1
    ((65, 40), torch.float32, 3),                    # M > 64
    ((30, 40), torch.float64, 3)])                   # not float32
def test_plain_path_outside_the_kernel_domain(shape, dtype, nq):
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(285.0, 5.0, shape)).to(dtype)
    q = np.linspace(0.0, 1.0, nq, dtype=np.float32)
    twins = axisquantile.twin_calls
    got = nan_quantile(x, q, axis=0)
    assert axisquantile.twin_calls == twins
    np.testing.assert_array_equal(got.numpy(),
                                  nan_quantile_plain(x, q, axis=0).numpy())


def test_tensor_q_and_negative_axis():
    x = _data(13, 2, seed=2)
    qt = torch.as_tensor(Q)
    got = nan_quantile(torch.as_tensor(x), qt, axis=-1).numpy()
    np.testing.assert_array_equal(got, _port(x, 2, 1.0, 1.0))


@pytest.mark.parametrize("M", [30, 65])
def test_kernel_wrapper_serves_only_cuda(M):
    x = torch.zeros(M, 8)
    with pytest.raises(ValueError, match="no axisquantile kernel"):
        axisquantile.axis_quantile_small(x, Q, 0)
