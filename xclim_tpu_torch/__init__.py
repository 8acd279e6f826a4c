"""xclim_tpu_torch: the PyTorch and CUDA port of xclim_tpu.

The same host-side CF semantics (units, calendars, group tables) driving
torch tensors on an NVIDIA GPU, with hand-written CUDA kernels where the JAX
package has Pallas kernels. Each kernel has a plain PyTorch twin that serves
CPU tensors; a CUDA tensor always goes to the kernel.
"""

import torch

__version__ = "0.1.0"

__all__ = ["climjit", "climjit_chain", "default_device"]


def default_device() -> torch.device:
    """Where host data given without a device goes: the current CUDA
    device. Data already on a device stays there. Raises when no CUDA
    device is present: host data then needs ``device="cpu"`` (or a CPU
    tensor), so that nothing lands on the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' or a CPU tensor to run the "
            "port's plain twins on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


from xclim_tpu_torch.core.jit_wrapper import climjit, climjit_chain  # noqa: E402
