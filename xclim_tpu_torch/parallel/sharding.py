"""Spatial blocks over the visible devices: the port's counterpart of the
JAX package's sharding over a (lat, lon) device mesh (reference scales via
``xr.apply_ufunc(..., dask='parallelized')``).

Every index is embarrassingly parallel over the non-time dims, so the
layout splits the two trailing (lat, lon) axes into one block per device of
a 2-D mesh and keeps time whole in each block. :func:`sharded_jit` runs a
function on each block on its device and joins the blocks' results. With
one card the mesh is (1, 1) and the call is the plain call on that card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SpaceMesh", "space_mesh", "shard_space", "sharded_jit",
           "pad_to_mesh"]


class SpaceMesh:
    """A 2-D ('lat', 'lon') grid of torch devices: ``devices`` is an
    object array of :class:`torch.device` of the mesh's shape."""

    axis_names = ("lat", "lon")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> tuple[int, int]:
        return self.devices.shape

    def __repr__(self):
        return f"SpaceMesh({self.shape[0]}x{self.shape[1]}, {self.devices.ravel().tolist()})"


def _visible_devices() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")]


def space_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None,
               devices=None) -> SpaceMesh:
    """Build a 2-D ('lat', 'lon') device mesh.

    With `shape` given, uses exactly that layout; otherwise factors n_devices
    as close to square as possible. The devices are `devices` (a list of
    torch devices; a CPU dry run may name the CPU several times) or the
    visible CUDA devices (the CPU where there is none).
    """
    devs = list(devices) if devices is not None else _visible_devices()
    n = n_devices or len(devs)
    if shape is None:
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (a, n // a)
    need = shape[0] * shape[1]
    if need > len(devs):
        raise ValueError(
            f"space_mesh: requested a {shape[0]}x{shape[1]} mesh "
            f"({need} devices) but only {len(devs)} device(s) are visible "
            f"on platform '{devs[0].type if devs else '?'}'. For a local "
            "dry run, pass devices=[torch.device('cpu')] * "
            f"{need}.")
    mesh_devs = np.empty(need, dtype=object)
    mesh_devs[:] = devs[:need]
    return SpaceMesh(mesh_devs.reshape(shape))


def _is_array(x) -> bool:
    return isinstance(x, torch.Tensor) or (hasattr(x, "data") and hasattr(x, "dims"))


def _block(x, i: int, j: int, mesh: SpaceMesh):
    """Block (i, j) of `x`'s two trailing axes on device (i, j) of the mesh
    (a ClimArray keeps its coordinates of those axes, cut to the block)."""
    la, lo = mesh.shape
    data = x.data if not isinstance(x, torch.Tensor) else x
    rows = torch.tensor_split(torch.arange(data.shape[-2]), la)[i]
    cols = torch.tensor_split(torch.arange(data.shape[-1]), lo)[j]
    r0, r1 = (int(rows[0]), int(rows[-1]) + 1) if len(rows) else (0, 0)
    c0, c1 = (int(cols[0]), int(cols[-1]) + 1) if len(cols) else (0, 0)
    blk = data[..., r0:r1, c0:c1].to(mesh.devices[i, j])
    if isinstance(x, torch.Tensor):
        return blk
    coords = dict(x.coords)
    for dim, (a, b) in zip(x.dims[-2:], ((r0, r1), (c0, c1))):
        if dim in coords:
            coords[dim] = np.asarray(coords[dim])[a:b]
    out = x.copy(data=blk)
    out.coords = coords
    return out


def shard_space(x, mesh: SpaceMesh, time_axis: int | None = 0) -> np.ndarray:
    """Split an array with dims (..., lat, lon) (a tensor or a ClimArray)
    into the mesh's blocks of its two trailing axes, each on its device:
    an object array of the mesh's shape. Blocks are as even as the extents
    allow (``torch.tensor_split``)."""
    out = np.empty(mesh.shape, dtype=object)
    for i in range(mesh.shape[0]):
        for j in range(mesh.shape[1]):
            out[i, j] = _block(x, i, j, mesh)
    return out


def pad_to_mesh(x, mesh: SpaceMesh, fill=np.nan):
    """Pad the trailing (lat, lon) axes of a tensor up to multiples of the
    mesh shape with `fill` (NaN by default: every index is NaN-aware, so
    padded cells flow through as missing and are sliced off afterwards).

    Returns ``(padded, unpad)`` where ``unpad(y)`` slices a result with the
    same trailing spatial extents back to the original grid.
    """
    la, lo = mesh.shape
    ny, nx = x.shape[-2], x.shape[-1]
    py = (-ny) % la
    px = (-nx) % lo
    if py == 0 and px == 0:
        return x, lambda y: y
    padded = torch.nn.functional.pad(x, (0, px, 0, py), value=fill)

    def unpad(y):
        return y[..., :ny, :nx]

    return padded, unpad


def _join(blocks: np.ndarray, device, names=None):
    """The blocks' results (tensors, ClimArrays, or tuples, lists or dicts
    of them) joined on `device`: a ClimArray along its dims `names` (the
    split dims of the input), where it has them, else along its two
    trailing axes."""
    first = blocks[0, 0]
    if blocks.shape == (1, 1):
        return _to(first, device)
    if isinstance(first, (tuple, list)):
        parts = [_join(_pick(blocks, k), device, names)
                 for k in range(len(first))]
        return type(first)(parts)
    if isinstance(first, dict):
        return {k: _join(_pick(blocks, k), device, names) for k in first}
    if not _is_array(first):
        return first
    tensor = isinstance(first, torch.Tensor)
    dims = first.ndim - 2, first.ndim - 1
    if not tensor and names and all(n in first.dims for n in names):
        dims = tuple(first.dims.index(n) for n in names)
    datas = [[b if tensor else b.data for b in row] for row in blocks]
    data = torch.cat([torch.cat([d.to(device) for d in row], dim=dims[1])
                      for row in datas], dim=dims[0])
    if tensor:
        return data
    coords = dict(first.coords)
    for k, axis in enumerate(dims):
        dim = first.dims[axis]
        if dim in coords:
            line = blocks[:, 0] if k == 0 else blocks[0, :]
            coords[dim] = np.concatenate([np.asarray(b.coords[dim]) for b in line])
    out = first.copy(data=data)
    out.coords = coords
    return out


def _to(x, device):
    """`x` (as in :func:`_join`) with its arrays on `device`."""
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x.to(device) if _is_array(x) else x


def _pick(blocks: np.ndarray, key) -> np.ndarray:
    out = np.empty(blocks.shape, dtype=object)
    for idx in np.ndindex(blocks.shape):
        out[idx] = blocks[idx][key]
    return out


def sharded_jit(fn, mesh: SpaceMesh, n_space_axes: int = 2, time_leading: bool = True):
    """Run `fn` block by block over the spatial mesh (the name is the JAX
    package's).

    Each argument that is a tensor or ClimArray with at least two dims is
    split over its two trailing (lat, lon) axes (:func:`shard_space`); the
    others are passed whole. `fn` runs on each block on its device, and the
    results are joined on the first array argument's device: a ClimArray
    along the dims of that name (outputs may add dims after them), a tensor
    along its two trailing axes. Only functions that act on each cell alone
    give the unsplit call's result.
    """
    if n_space_axes != 2:
        raise ValueError("sharded_jit splits the two trailing (lat, lon) axes")

    def wrapper(*args, **kwargs):
        arrays = [a for a in args if _is_array(a) and a.ndim >= 2]
        home = (arrays[0] if isinstance(arrays[0], torch.Tensor)
                else arrays[0].data).device if arrays else None
        outs = np.empty(mesh.shape, dtype=object)
        for i in range(mesh.shape[0]):
            for j in range(mesh.shape[1]):
                blk = [_block(a, i, j, mesh) if _is_array(a) and a.ndim >= 2
                       else a for a in args]
                outs[i, j] = fn(*blk, **kwargs)
        names = tuple(arrays[0].dims[-2:]) if arrays and not isinstance(
            arrays[0], torch.Tensor) else None
        return _join(outs, home if home is not None else mesh.devices[0, 0],
                     names)

    return wrapper
