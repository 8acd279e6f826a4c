"""The port's sort quantile against the JAX package's XLA formulation
(``nan_quantile(..., _no_pallas=True)``) on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.ops.quantile import nan_percentile as jnan_percentile
from xclim_tpu.ops.quantile import nan_quantile as jnan_quantile
from xclim_tpu_torch.ops.quantile import nan_percentile, nan_quantile

Q = np.asarray([0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0], np.float32)
ALPHA_BETA = [(1.0, 1.0), (1.0 / 3.0, 1.0 / 3.0)]


def _data(shape, axis, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.2] = np.nan
    xm = np.moveaxis(x, axis, -1)       # view: lane edits land in x
    xm[0, ...] = np.nan                 # all-NaN lanes
    xm[1, ..., 1:] = np.nan             # single valid value
    xm[2, ..., ::2] = xm[2, ..., :1]    # ties
    return x


def _close(got, exp):
    assert got.shape == exp.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # f32 op sequence shared; the reference's one-hot einsum rounds the two
    # weighted terms within a few ulp (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("alpha,beta", ALPHA_BETA)
@pytest.mark.parametrize("shape,axis", [((4, 37, 6), 1), ((5, 3, 64), -1),
                                        ((150, 3, 4), 0)])
def test_nan_quantile(alpha, beta, shape, axis):
    x = _data(shape, axis, seed=len(shape) + shape[0])
    got = nan_quantile(torch.as_tensor(x), Q, axis=axis, alpha=alpha,
                       beta=beta).numpy()
    exp = np.asarray(jnan_quantile(jnp.asarray(x), Q, axis=axis, alpha=alpha,
                                   beta=beta, _no_pallas=True))
    _close(got, exp)


@pytest.mark.parametrize("alpha,beta", ALPHA_BETA)
def test_nan_percentile(alpha, beta):
    x = _data((3, 40, 5), 1, seed=7)
    per = [10, 50, 90]
    got = nan_percentile(torch.as_tensor(x), per, axis=1, alpha=alpha,
                         beta=beta).numpy()
    exp = np.asarray(jnan_percentile(jnp.asarray(x), per, axis=1, alpha=alpha,
                                     beta=beta))
    _close(got, exp)


def test_nan_quantile_tensor_q_and_1d():
    x = _data((3, 25), 1, seed=3)[1:].reshape(-1)
    qt = torch.as_tensor(Q)
    got = nan_quantile(torch.as_tensor(x), qt, axis=0).numpy()
    exp = np.asarray(jnan_quantile(jnp.asarray(x), Q, axis=0,
                                   _no_pallas=True))
    _close(got, exp)
