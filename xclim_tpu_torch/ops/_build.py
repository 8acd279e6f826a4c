"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. On first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``xclim_tpu_torch/_build/`` and
loaded with :mod:`ctypes`; PyTorch's headers are never included, so a build
takes seconds. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt. A missing ``nvcc`` or a failed build
raises with the compiler's output: there is no fallback.

A build target is a source's name, or a name in :data:`VARIANTS`, which
compiles a source with extra flags (``winquantile_stages``: the winquantile
kernel with its profiling stages, which the shipped library leaves out;
``winquantile_count`` and ``betainc_count``: the counting builds,
``-DXTT_COUNT``, whose kernels add their counters to a buffer given as
their last argument); :data:`TARGETS` lists them all. :data:`COUNTING`
names the counting build of a kernel and its entry: the op launches it
instead of the shipped one while the program is tracing
(``utils/profiling.py``), and :func:`prepare_counting`, called on entering
a tracing block, builds and binds those of the kernels loaded so far.

Every launch of a kernel goes through :func:`launch`: the entry is bound
once (:func:`function`), called inside ``torch.cuda.device`` with the
device's current stream as its last argument, and a nonzero return (a CUDA
error code) raises. :func:`device_copy` puts host constants on the device
once per value set.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["build", "load", "build_info", "source", "function", "launch",
           "device_copy", "prepare_counting", "TARGETS", "VARIANTS",
           "COUNTING"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_OUT = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: build target -> (source name under csrc/, extra nvcc flags)
VARIANTS = {"winquantile_stages": ("winquantile",
                                   ("-DXTT_WINQUANTILE_STAGES",)),
            "winquantile_count": ("winquantile", ("-DXTT_COUNT",)),
            "betainc_count": ("betainc", ("-DXTT_COUNT",))}
#: shipped target -> (its counting build, the entry, the entry's argument
#: codes before the stream: the shipped entry's, then the counts buffer);
#: the build also has ``<entry>_load()``, which loads its kernels
COUNTING = {"winquantile": ("winquantile_count", "xtt_winquantile_count",
                            "ppppppiiiiiiqp"),
            "betainc": ("betainc_count", "xtt_betainc_count", "ppppqiiiip")}
#: every build target: the sources under csrc/ and the variants
TARGETS = tuple(sorted([p.stem for p in _SRC.glob("*.cu")] + list(VARIANTS)))
#: argument and return codes of function(): a pointer, an int, a long
#: long, a float
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
           "f": ctypes.c_float}

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


def source(name: str) -> Path:
    """The ``csrc/*.cu`` file that build target ``name`` compiles."""
    return _SRC / f"{VARIANTS.get(name, (name,))[0]}.cu"


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + VARIANTS.get(name, (name, ()))[1]


def _so_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return _OUT / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Build the libraries of the targets ``names`` that are not built yet,
    one nvcc process per target, all started together. Raises with the
    compiler's output if any build fails."""
    todo = []
    for name in dict.fromkeys(names):
        if _so_path(name).exists():
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        else:
            todo.append(name)
    if not todo:
        return
    nvcc = _nvcc()
    _OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        so = _so_path(name)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, proc, t0 in jobs:
        log = proc.communicate()[0]
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed building {name} from "
                          f"{source(name).name} (exit {proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of build target ``name``, building it if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_so_path(name)))
    _libs[name] = lib
    return lib


@functools.cache
def function(target: str, symbol: str, argtypes: str, restype: str = "i"):
    """The entry ``symbol`` of build target ``target``'s library, bound
    once to the C signature given as codes of ``_CTYPES`` (``argtypes``
    one code an argument, ``restype`` the return's)."""
    fn = getattr(load(target), symbol)
    fn.argtypes = [_CTYPES[c] for c in argtypes]
    fn.restype = _CTYPES[restype]
    return fn


def launch(target: str, symbol: str, argtypes: str, device: torch.device,
           *args) -> None:
    """Launch the kernel entry ``symbol`` of build target ``target`` on
    ``device``: ``symbol(*args, stream)`` with the device's current
    stream, ``argtypes`` the codes of ``args``. Raises RuntimeError naming
    the kernel's source if the entry returns a CUDA error."""
    fn = function(target, symbol, argtypes + "p")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{source(target).stem} kernel launch failed: "
                           f"CUDA error {err}")


def prepare_counting() -> None:
    """Build (one nvcc each, together), bind and load the kernels of the
    counting build of each loaded kernel that has one (:data:`COUNTING`),
    so that a launch while tracing neither compiles nor waits for CUDA to
    load a kernel on its first use. Raises if the loading fails."""
    todo = [COUNTING[t] for t in list(_libs) if t in COUNTING]
    build([target for target, _, _ in todo])
    for target, symbol, argtypes in todo:
        function(target, symbol, argtypes + "p")
        err = function(target, symbol + "_load", "")()
        if err != 0:
            raise RuntimeError(f"{source(target).stem} counting build: "
                               f"loading its kernels failed: CUDA error "
                               f"{err}")


@functools.lru_cache(maxsize=256)
def device_copy(data: bytes, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The host bytes ``data`` as a 1-D ``dtype`` tensor on ``device``,
    copied once per value: a copy from host memory on every call would
    wait for the device each time."""
    return torch.frombuffer(bytearray(data), dtype=dtype).to(device)
