"""ctypes bindings for the native NetCDF3 reader (compiled on first use).

The native library mmaps the file and byte-swaps variables with multiple
threads: the fast IO path for classic NetCDF inputs. It is compiled with
g++ into ``xclim_tpu_torch/_build/`` (the file name carries a hash of the
source and flags, so an edited source is rebuilt). Without a compiler the
reader is unavailable and :mod:`xclim_tpu_torch.io.netcdf` reads with scipy
(and counts which reader served each open)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "ncreader.cpp"
_OUT = Path(__file__).resolve().parents[2] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_NC_DTYPES = {1: np.int8, 2: np.dtype("S1"), 3: np.int16, 4: np.int32,
              5: np.float32, 6: np.float64}

_lib = None


def lib_path() -> Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _OUT / f"libncreader-{digest}.so"


def _build(so: Path) -> bool:
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        _OUT.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, so)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """Load (compiling if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    so = lib_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.nc3_open.restype = ctypes.c_void_p
    lib.nc3_open.argtypes = [ctypes.c_char_p]
    lib.nc3_error.restype = ctypes.c_char_p
    lib.nc3_error.argtypes = [ctypes.c_void_p]
    lib.nc3_close.argtypes = [ctypes.c_void_p]
    lib.nc3_num_dims.argtypes = [ctypes.c_void_p]
    lib.nc3_dim_name.restype = ctypes.c_char_p
    lib.nc3_dim_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nc3_dim_size.restype = ctypes.c_int64
    lib.nc3_dim_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nc3_num_vars.argtypes = [ctypes.c_void_p]
    lib.nc3_var_name.restype = ctypes.c_char_p
    lib.nc3_var_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nc3_var_type.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nc3_var_ndims.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nc3_var_dimid.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.nc3_var_natts.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nc3_att_name.restype = ctypes.c_char_p
    lib.nc3_att_name.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.nc3_att_type.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.nc3_att_nelems.restype = ctypes.c_int64
    lib.nc3_att_nelems.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.nc3_att_values.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_void_p]
    lib.nc3_var_nelems.restype = ctypes.c_int64
    lib.nc3_var_nelems.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.nc3_read_var.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    _lib = lib
    return lib


class NativeNC3:
    """Pythonic view over the native reader."""

    def __init__(self, path):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native ncreader unavailable")
        self.lib = lib
        self.h = lib.nc3_open(str(path).encode())
        err = lib.nc3_error(self.h).decode()
        if err:
            lib.nc3_close(self.h)
            raise ValueError(f"ncreader: {err}")
        self.dims = {}
        for i in range(lib.nc3_num_dims(self.h)):
            self.dims[lib.nc3_dim_name(self.h, i).decode()] = lib.nc3_dim_size(self.h, i)
        self._dimnames = list(self.dims)

    def close(self):
        if self.h:
            self.lib.nc3_close(self.h)
            self.h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _atts(self, vi: int) -> dict:
        out = {}
        for a in range(self.lib.nc3_var_natts(self.h, vi)):
            name = self.lib.nc3_att_name(self.h, vi, a).decode()
            t = self.lib.nc3_att_type(self.h, vi, a)
            n = self.lib.nc3_att_nelems(self.h, vi, a)
            buf = np.empty(n, dtype=_NC_DTYPES[t])
            self.lib.nc3_att_values(self.h, vi, a, buf.ctypes.data_as(ctypes.c_void_p))
            if t == 2:
                out[name] = buf.tobytes().decode("utf-8", "replace")
            elif n == 1:
                out[name] = buf[0].item()
            else:
                out[name] = buf
        return out

    @property
    def global_attrs(self) -> dict:
        return self._atts(-1)

    def variables(self) -> dict:
        """{name: (dims tuple, numpy array, attrs dict)}."""
        out = {}
        for i in range(self.lib.nc3_num_vars(self.h)):
            name = self.lib.nc3_var_name(self.h, i).decode()
            t = self.lib.nc3_var_type(self.h, i)
            nd = self.lib.nc3_var_ndims(self.h, i)
            dims = tuple(self._dimnames[self.lib.nc3_var_dimid(self.h, i, d)]
                         for d in range(nd))
            shape = tuple(self.dims[d] for d in dims)
            n = self.lib.nc3_var_nelems(self.h, i)
            buf = np.empty(n, dtype=_NC_DTYPES[t])
            rc = self.lib.nc3_read_var(self.h, i, buf.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise ValueError(f"ncreader: failed reading {name} (rc={rc})")
            out[name] = (dims, buf.reshape(shape), self._atts(i))
        return out
