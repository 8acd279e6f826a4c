"""xclim_tpu_torch: the PyTorch and CUDA port of xclim_tpu.

The same host-side CF semantics (units, calendars, group tables) driving
torch tensors on an NVIDIA GPU, with hand-written CUDA kernels where the JAX
package has Pallas kernels. Each kernel has a plain PyTorch twin that serves
CPU tensors; a CUDA tensor always goes to the kernel.
"""

import torch

__version__ = "0.1.0"

__all__ = ["atmos", "build_indicator_module_from_yaml", "climjit",
           "climjit_chain", "default_device", "generic", "indicators",
           "indices", "land", "seaIce", "set_options", "units"]


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


#: the names ``xclim_tpu/__init__.py`` exports, loaded on first use so that
#: ``import xclim_tpu_torch`` loads only torch: name -> (module, attribute)
_LAZY = {
    "set_options": ("xclim_tpu_torch.core.options", "set_options"),
    "units": ("xclim_tpu_torch.core.units", None),
    "indices": ("xclim_tpu_torch.indices", None),
    "indicators": ("xclim_tpu_torch.indicators", None),
    "atmos": ("xclim_tpu_torch.indicators.atmos", None),
    "generic": ("xclim_tpu_torch.indicators.generic", None),
    "land": ("xclim_tpu_torch.indicators.land", None),
    "seaIce": ("xclim_tpu_torch.indicators.seaIce", None),
    "build_indicator_module_from_yaml": ("xclim_tpu_torch.core.indicator",
                                         "build_indicator_module_from_yaml"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module 'xclim_tpu_torch' has no attribute {name!r}")
    import importlib

    modname, attr = _LAZY[name]
    # the realms come with the YAML modules, as `import xclim_tpu` gives both
    importlib.import_module("xclim_tpu_torch.indicators")
    mod = importlib.import_module(modname)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value
