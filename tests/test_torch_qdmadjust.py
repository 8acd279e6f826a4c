"""The qdmadjust op's plain twin (grouped_rank + interp_hat_nodes) against
the JAX package's ``_qdm_adjust_core`` on the same numpy doy slices, with
ties and NaN lanes, and the port's rank/interpolation utilities against the
reference's. The kernel itself is checked on the card by
test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xclim_tpu.sdba import utils as jutils
from xclim_tpu.sdba.adjustment import _qdm_adjust_core
from xclim_tpu_torch.ops import qdmadjust
from xclim_tpu_torch.sdba import utils as tutils

Q = tutils.equally_spaced_nodes(50).astype(np.float32)


def _case(G, Y, C, nanfrac, seed):
    rng = np.random.default_rng(seed)
    xd = rng.normal(289.0, 6.0, (G, Y, C)).astype(np.float32)
    xd[rng.random(xd.shape) < nanfrac] = np.nan
    xd[:, :, 0] = np.nan                    # all-NaN lane
    xd[:, 1:, 1] = np.nan                   # single valid sample
    xd[:, :, 2] = xd[:, :1, 2]              # one full tie run
    xd[:, ::3, 3] = np.round(xd[:, ::3, 3])  # partial ties
    af = np.sort(rng.normal(0.0, 2.0, (G, len(Q), C)).astype(np.float32),
                 axis=1)
    return xd, af


def _reference(xd, af, kind):
    """_qdm_adjust_core on a time axis that is the flattened slices."""
    G, Y, C = xd.shape
    table = np.arange(G * Y, dtype=np.int32).reshape(G, Y)
    out = _qdm_adjust_core(jnp.asarray(xd.reshape(G * Y, C)),
                           jnp.asarray(table), jnp.arange(G * Y),
                           jnp.asarray(af), jnp.asarray(Q), kind=kind,
                           interp="linear", extrapolation="constant")
    return np.asarray(out).reshape(G, Y, C)


def _close(got, exp):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # ranks are exact counts; the interpolation is the same f32 op sequence
    # (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("G,Y,C,nanfrac", [(7, 30, 9, 0.0), (5, 13, 8, 0.3),
                                           (3, 64, 6, 0.1), (366, 6, 5, 0.2)])
def test_twin_matches_reference(kind, G, Y, C, nanfrac):
    xd, af = _case(G, Y, C, nanfrac, seed=G * C + Y)
    got = qdmadjust.qdm_adjust_doy_plain(torch.as_tensor(xd),
                                         torch.as_tensor(af), Q, kind).numpy()
    _close(got, _reference(xd, af, kind))


def test_cpu_tensor_takes_twin_and_counts():
    xd, af = _case(4, 10, 5, 0.1, seed=5)
    launches, twins = qdmadjust.launches, qdmadjust.twin_calls
    out = qdmadjust.qdm_adjust_doy(torch.as_tensor(xd), torch.as_tensor(af),
                                   Q, "*")
    assert (qdmadjust.launches, qdmadjust.twin_calls) == (launches, twins + 1)
    _close(out.numpy(), _reference(xd, af, "*"))


@pytest.mark.parametrize("ms", [20, 200])
def test_grouped_rank_both_formulations(ms):
    rng = np.random.default_rng(ms)
    g = np.round(rng.normal(0, 3, (4, ms, 6))).astype(np.float32)  # ties
    g[rng.random(g.shape) < 0.2] = np.nan
    nv = (~np.isnan(g)).sum(axis=1)
    got = tutils.grouped_rank(torch.as_tensor(g), torch.as_tensor(nv)).numpy()
    exp = np.asarray(jutils.grouped_rank(jnp.asarray(g), jnp.asarray(nv)))
    ok = ~np.isnan(g)       # NaN slots carry an inert rank in both engines
    np.testing.assert_array_equal(got[ok], exp[ok])


def test_interp_on_quantiles():
    rng = np.random.default_rng(9)
    xq = np.sort(rng.normal(0, 2, (3, 12, 5)), axis=1).astype(np.float32)
    yq = rng.normal(0, 1, (3, 12, 5)).astype(np.float32)
    x = rng.normal(0, 3, (3, 20, 5)).astype(np.float32)
    x[0, :3] = np.nan
    for extrap in ("constant", "nan"):
        got = tutils.interp_on_quantiles(torch.as_tensor(x),
                                         torch.as_tensor(xq),
                                         torch.as_tensor(yq),
                                         extrapolation=extrap).numpy()
        exp = np.asarray(jutils.interp_on_quantiles(
            jnp.asarray(x), jnp.asarray(xq), jnp.asarray(yq),
            extrapolation=extrap))
        _close(got, exp)


@pytest.mark.parametrize("kwargs,err", [
    ({"kind": "-"}, ValueError),
    ({"q": Q[:1]}, ValueError),
    ({"af": torch.zeros(4, 3, 5)}, ValueError),
])
def test_rejects_bad_arguments(kwargs, err):
    xd, af = _case(4, 10, 5, 0.0, seed=1)
    args = {"xd": torch.as_tensor(xd), "af": torch.as_tensor(af), "q": Q,
            "kind": "+"} | kwargs
    with pytest.raises(err):
        qdmadjust.qdm_adjust_doy(**args)
