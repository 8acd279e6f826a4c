"""xclim_tpu_torch: the PyTorch and CUDA port of xclim_tpu.

The same host-side CF semantics (units, calendars, group tables) driving
torch tensors on an NVIDIA GPU, with hand-written CUDA kernels where the JAX
package has Pallas kernels. Each kernel has a plain PyTorch twin that serves
CPU tensors; a CUDA tensor always goes to the kernel.
"""

import torch

__version__ = "0.1.0"

__all__ = ["default_device"]


def default_device() -> torch.device:
    """Where to create new data: the current CUDA device when one is
    present, else the CPU. Data already on a device stays there."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
