"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. These need an NVIDIA GPU with nvcc and skip elsewhere. The file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from xclim_tpu_torch.ops import qdmadjust, winquantile
from xclim_tpu_torch.sdba.utils import equally_spaced_nodes

# the string condition is evaluated when each test is set up, not when the
# module is imported, so every worker collects the same tests
pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU: the CUDA kernels have no CPU mode")]

Q = equally_spaced_nodes(50).astype(np.float32)


@pytest.fixture(scope="module")
def cuda():
    return torch.device("cuda")


def _slices(n_doy, Y, C, seed, nanfrac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(285.0, 5.0, (n_doy, Y, C)).astype(np.float32)
    x[rng.random(x.shape) < nanfrac] = np.nan
    x[:, :, 0] = np.nan                          # all-NaN lane
    if C > 1:
        x[:, 1:, 1] = np.nan                     # single valid sample
    if C > 2:
        x[:, ::2, 2] = np.round(x[:, ::2, 2])    # ties
    return x


def _close(got, exp):
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    # one f32 op sequence on both paths (1e-6, SURVEY §6)
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6, equal_nan=True)


# padded window P2 = next pow2 of window*Y: 1024, 256, 8, 128, 2048, 4,
# 64, 512 take the register sort (P2 <= 1024) or the shared-memory sort
# (2048 with 4 cells a block, 4096 with 2, 8192 with 1)
@pytest.mark.parametrize("n_doy,Y,C,window", [
    (365, 30, 300, 31), (366, 30, 300, 5), (360, 7, 37, 1),
    (365, 3, 5, 31), (365, 64, 40, 31), (10, 1, 9, 3), (20, 12, 10, 5),
    (365, 16, 20, 31), (365, 100, 5, 31), (40, 200, 3, 31)])
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1 / 3, 1 / 3)])
def test_winquantile_kernel_matches_twin(cuda, n_doy, Y, C, window, alpha,
                                         beta):
    x = torch.as_tensor(_slices(n_doy, Y, C, seed=n_doy + Y + C), device=cuda)
    before = winquantile.launches
    got = winquantile.doy_window_quantiles(x, Q, window, alpha, beta)
    torch.cuda.synchronize()
    assert winquantile.launches == before + 1
    _close(got, winquantile.doy_window_quantiles_plain(x, Q, window, alpha,
                                                       beta))


def test_winquantile_rejects_oversized_window(cuda):
    x = torch.zeros(365, 300, 2, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        winquantile.doy_window_quantiles(x, Q, 31)


@pytest.mark.parametrize("kind", ["+", "*"])
@pytest.mark.parametrize("n_doy,Y,C,nanfrac", [
    (365, 30, 300, 0.0), (366, 30, 300, 0.2), (5, 64, 70, 0.1),
    (7, 1, 33, 0.0), (12, 13, 3, 0.5)])
def test_qdmadjust_kernel_matches_twin(cuda, kind, n_doy, Y, C, nanfrac):
    rng = np.random.default_rng(n_doy * Y + C)
    xd = torch.as_tensor(_slices(n_doy, Y, C, seed=C, nanfrac=nanfrac),
                         device=cuda)
    af = torch.as_tensor(np.sort(rng.normal(0.0, 2.0, (n_doy, len(Q), C)),
                                 axis=1).astype(np.float32), device=cuda)
    before = qdmadjust.launches
    got = qdmadjust.qdm_adjust_doy(xd, af, Q, kind)
    torch.cuda.synchronize()
    assert qdmadjust.launches == before + 1
    _close(got, qdmadjust.qdm_adjust_doy_plain(xd, af, Q, kind))


def test_qdmadjust_rejects_too_many_years(cuda):
    xd = torch.zeros(3, qdmadjust.MAX_Y + 1, 4, device=cuda)
    af = torch.zeros(3, len(Q), 4, device=cuda)
    with pytest.raises(ValueError, match="year slots"):
        qdmadjust.qdm_adjust_doy(xd, af, Q)
