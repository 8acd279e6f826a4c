"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``xclim_tpu_torch/_build/`` and
loaded with :mod:`ctypes`; PyTorch's headers are never included, so a build
takes seconds. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt. A missing ``nvcc`` or a failed build
raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
#: per kernel: {"seconds": build time (0.0 when loaded from a previous
#: build), "log": nvcc's output including ptxas' register/smem report}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of xclim_tpu_torch cannot be built")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = _SRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _OUT / f"lib{name}-{digest}.so"
    info = {"seconds": 0.0, "log": ""}
    if not so.exists():
        _OUT.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        info["seconds"] = time.perf_counter() - t0
        info["log"] = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed building {src.name} "
                               f"(exit {res.returncode}):\n{info['log']}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _libs[name] = lib
    build_info[name] = info
    return lib
