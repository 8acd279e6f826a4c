"""Windowed day-of-year group quantiles: the sdba training kernel.

The quantile-mapping trainers need, for every day-of-year group g, the
quantiles of ALL samples whose doy falls in a ±half window around g (window
31 in the north-star config). :func:`doy_window_quantiles` computes them
from the (n_doy, Y, C) doy slices:

* on a CUDA tensor it launches the hand-written kernel
  ``csrc/winquantile.cu`` (a sorted window slides along a chunk of the doy
  axis, one slice out and one merged in per doy) and raises if the launch
  fails;
* on a CPU tensor it runs :func:`doy_window_quantiles_plain`, the plain
  PyTorch twin: the windowed gather plus the sort quantile of
  :func:`~xclim_tpu_torch.ops.quantile.nan_quantile_plain`, chunked over
  cells (never the dispatcher, so the twin stays plain on the card).

The window's size picks the kernel's instance (:func:`instance`; the
padded window is ``window * Y`` rounded up to a power of two):

* ``"warp"``, a padded window of at most :data:`WARP_P2` = 1024 samples
  (w31 up to 33 years, w5 up to 204, window 1 up to 1024; sdba's w31 x 30
  years): one warp owns one cell's sorted window in shared memory for its
  whole doy chunk, with no block barrier between slides (one every few
  doys writes the staged node values). Each slice is sorted by the warp as
  it enters and as it leaves; a slide reads and writes each window entry
  once, and finds where each lane starts by binary searches over the
  <= Y slice values, never over the window. No presort pass and no
  scratch: the call allocates its output only. What bounds it is issue
  and latency, ~1000 warp instructions a (cell, doy) slide: ~42 ms a
  launch at (365, 30, 65536) on an H100, against ~2.3 ms of device-memory
  bytes;
* ``"shared"``, up to :data:`MAX_P2` = 8192 samples (w61 x 30, w31 x 60
  years): each doy slice presorted once into an (n_doy, C, Y) scratch
  array, and a block keeps the sorted windows of 8192 / padded window
  cells in shared memory and merges the presorted slices;
* ``"global"``, past MAX_P2 (w31 over more than 264 years, w91 over more
  than 90): the same slides, one cell a block, on the block's own region
  of a scratch array the wrapper allocates (``xtt_winquantile_scratch``
  floats, ~140 MB at w31 x 300 years).

The only limit left is :data:`MAX_WINDOW` samples a window, which the
kernel's float32 valid count holds exactly; past it the call raises.

:func:`doy_window_stage` runs the same kernel stopped after a stage (the
card profile of ``xclim_tpu_torch/tools/prof_winquantile.py``), from a
second build of the source with its stages compiled in (build target
``winquantile_stages``); :func:`stage_plain` gives each stage's result by
plain torch.

``launches`` counts the calls of :func:`doy_window_quantiles` that ran on
the card (one kernel launch in the warp instance; the presort pass and the
sliding kernel in the others, or the sliding kernel alone when every doy
is its own chunk); of those, ``global_launches`` those of the
global-scratch instance; ``twin_calls`` the calls the twin served on CPU
tensors; ``stage_launches`` the calls of :func:`doy_window_stage` that ran
on the card. The program's counters
(:func:`~xclim_tpu_torch.utils.profiling.count`, inside the
``op.winquantile`` span while tracing): ``winquantile_warp_launches``, one a
launch of the warp instance; and, while tracing, the card launches the
counting build of the kernel (build target ``winquantile_count``), which
adds :data:`COUNTERS` (the warp instance all of them, the stage cycles and
the walk's steps and lanes in one block of :data:`SAMPLE_EVERY`; the
other instances the values entering and leaving windows), while the twin
counts
``winquantile_inserted`` and ``winquantile_removed`` exactly as the card
does: the valid values of the slices entering and leaving a window at
each slide, a chunk start (:func:`doy_chunks`) sorting its window whole
and counting none.
"""

from __future__ import annotations

import torch

from xclim_tpu_torch.ops import _build
from xclim_tpu_torch.ops.quantile import _node_constants, nan_quantile_plain
from xclim_tpu_torch.utils import profiling
from xclim_tpu_torch.utils.profiling import count, span

__all__ = ["doy_window_quantiles", "doy_window_quantiles_plain",
           "doy_window_stage", "stage_plain", "doy_chunks",
           "window_in_shared", "instance"]

#: calls of doy_window_quantiles that ran on the card
launches = 0
#: of those, the calls whose windows took the global-scratch instance
global_launches = 0
#: calls doy_window_quantiles served with the plain twin (CPU tensors)
twin_calls = 0
#: calls of doy_window_stage that ran on the card
stage_launches = 0

#: largest window (window * Y samples, rounded up to a power of two) one
#: warp sorts and slides (the warp instance)
WARP_P2 = 1024
#: largest window the kernel sorts and slides in one block's shared memory
MAX_P2 = 8192
#: most samples a window may hold (window * Y): the kernel counts a
#: window's valid samples in float32, exact up to 2^24
MAX_WINDOW = 1 << 24
#: the kernel's stages: 0 loads, and the presort where the instance has
#: one (the window's valid count), 1 + sorts and slides (the window's
#: smallest valid value), 2 + node selection
STAGES = ("load_presort", "slide", "full")
#: blocks a launch aims for: several waves of resident blocks on 132 SMs.
#: Each chunk sorts its first window in full, which costs more in shared
#: memory (windows above 1024 samples): those aim for fewer blocks
TARGET_BLOCKS = 4096
TARGET_BLOCKS_SMEM = 1024

_SLAB_BYTES = 1 << 30
#: the counting build times the stages and counts the walk in the warp
#: instance's blocks whose cell group is a multiple of this
#: (csrc/winquantile.cu kSampleEvery): every warp's would cost ~7 %
SAMPLE_EVERY = 32

#: the counting build's counters, in the order of csrc/winquantile.cu's
#: Counter: the (cell, doy) slides run (chunk starts excluded), and of
#: those the sampled blocks' (one block of the warp instance in
#: SAMPLE_EVERY); the sampled warps' clock64 cycles in the chunk-start
#: sort, the slices' loads and sorts, the searches and the walk, and node
#: selection with its staging, barrier and write-out; their walk's entry
#: steps, those at which at least one lane inserts or removes, and the
#: lanes that do, summed over those steps; every warp's valid values
#: entering and leaving windows
COUNTERS = ("winquantile_slides", "winquantile_sampled_slides",
            "winquantile_cycles_sort",
            "winquantile_cycles_slices", "winquantile_cycles_walk",
            "winquantile_cycles_nodes", "winquantile_walk_steps",
            "winquantile_walk_branch_steps", "winquantile_walk_branch_lanes",
            "winquantile_inserted", "winquantile_removed")


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _check(xg: torch.Tensor, window: int):
    if xg.dtype != torch.float32:
        raise TypeError(f"xg must be float32, got {xg.dtype}")
    if xg.ndim != 3:
        raise ValueError(f"xg must be (n_doy, Y, C), got shape {tuple(xg.shape)}")
    if window % 2 != 1 or window < 1:
        raise ValueError("window must be a positive odd number")


def window_in_shared(window: int, Y: int) -> bool:
    """Whether the kernel keeps a window of ``window`` doys x ``Y`` years
    in shared memory: its padded size (a power of two) fits MAX_P2
    samples. Otherwise the global-scratch instance takes it."""
    return instance(window, Y) != "global"


def instance(window: int, Y: int) -> str:
    """The kernel's instance for a window of ``window`` doys x ``Y``
    years, by its padded size (``window * Y`` rounded up to a power of two,
    at least 32): "warp" up to WARP_P2 samples, "shared" up to MAX_P2,
    "global" past it."""
    P2 = max(32, _pow2(window * Y))
    return ("warp" if P2 <= WARP_P2
            else "shared" if P2 <= MAX_P2 else "global")


def cells_per_block(window: int, Y: int) -> int:
    """Cells one block of the kernel takes: 8 in the warp instance (one a
    warp), else 8192 / padded window, and one past MAX_P2 (the
    global-scratch instance)."""
    P2 = max(32, _pow2(window * Y))
    return 8 if P2 <= WARP_P2 else max(1, MAX_P2 // P2)


def doy_chunks(n_doy: int, C: int, window: int, Y: int) -> int:
    """How many chunks the kernel splits the doy axis into: enough that
    (cell groups x chunks) reaches TARGET_BLOCKS (TARGET_BLOCKS_SMEM for a
    window above 1024 padded samples), at most n_doy. Each chunk sorts its
    first window in full, then slides."""
    groups = -(-C // cells_per_block(window, Y))
    target = (TARGET_BLOCKS if instance(window, Y) == "warp"
              else TARGET_BLOCKS_SMEM)
    return max(1, min(n_doy, -(-target // max(groups, 1))))


def doy_window_quantiles(xg: torch.Tensor, q, window: int, alpha: float = 1.0,
                         beta: float = 1.0) -> torch.Tensor:
    """Quantiles of each wrapped ±(window//2)-doy group of slices.

    xg: (n_doy, Y, C) float32, NaN where missing (slot y of doy d = d-th doy
    of the y-th year, or NaN). q: (nq,) quantile nodes in [0, 1].
    Returns (n_doy, nq, C) on xg's device, with the Hyndman-Fan alpha/beta
    semantics of :func:`~xclim_tpu_torch.ops.quantile.nan_quantile` (no
    valid samples -> NaN).
    """
    global launches, twin_calls, global_launches
    with span("op.winquantile"):
        _check(xg, window)
        if xg.device.type == "cpu":
            twin_calls += 1
            return doy_window_quantiles_plain(xg, q, window, alpha, beta)
        out = _launch(xg, q, window, alpha, beta, None)
        launches += 1
        which = instance(window, xg.shape[1])
        if which == "warp":
            count("winquantile_warp_launches")
        elif which == "global":
            global_launches += 1
        return out


def doy_window_stage(xg: torch.Tensor, q, window: int, stage: int,
                     alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """The kernel stopped after ``stage`` (see STAGES): (n_doy, C) for
    stages 0 and 1, the quantiles for 2. A CPU tensor gets
    :func:`stage_plain`."""
    global stage_launches
    _check(xg, window)
    if stage not in (0, 1, 2):
        raise ValueError(f"stage must be 0, 1 or 2, got {stage}")
    if xg.device.type == "cpu":
        return stage_plain(xg, q, window, stage, alpha, beta)
    out = _launch(xg, q, window, alpha, beta, stage)
    stage_launches += 1
    return out


def _launch(xg, q, window, alpha, beta, stage):
    if xg.device.type != "cuda":
        raise ValueError(f"no winquantile kernel for device {xg.device}")
    n_doy, Y, C = xg.shape
    if window * Y > MAX_WINDOW:
        raise ValueError(f"window*Y = {window * Y} exceeds the kernel's "
                         f"{MAX_WINDOW}-sample window")
    qv, coff = _node_constants(q, alpha, beta)
    nq = len(qv)
    x = xg.contiguous()
    qv_d, co_d = (_build.device_copy(a.tobytes(), torch.float32, x.device)
                  for a in (qv, coff))
    shape = (n_doy, nq, C) if stage in (None, 2) else (n_doy, C)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    nchunk = doy_chunks(n_doy, C, window, Y)
    # scratch for the presorted slices: none in the warp instance (each
    # slice sorted as it enters), nor when every doy is its own chunk
    presort = (instance(window, Y) != "warp"
               and not (window > 1 and nchunk == n_doy))
    presorted = torch.empty((n_doy, C, Y) if presort else (0,),
                            dtype=torch.float32, device=x.device)
    # windows past MAX_P2 keep their sorted rows in global scratch
    scratch_n = _build.function("winquantile", "xtt_winquantile_scratch",
                                "iiiii", "q")(n_doy, Y, C, window, nchunk)
    scratch = torch.empty((scratch_n,), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), presorted.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), qv_d.data_ptr(), co_d.data_ptr(), n_doy, Y, C,
            window, nq, nchunk, scratch_n)
    if stage is None and profiling.active():
        counts = torch.zeros(len(COUNTERS), dtype=torch.int64, device=x.device)
        _build.launch(*_build.COUNTING["winquantile"], x.device, *args,
                      counts.data_ptr())
        count(COUNTERS, counts)
    elif stage is None:
        _build.launch("winquantile", "xtt_winquantile", "ppppppiiiiiiq",
                      x.device, *args)
    else:
        _build.launch("winquantile_stages", "xtt_winquantile_stages",
                      "ppppppiiiiiiqi", x.device, *args, stage)
    return out


def _window_rows(n_doy: int, window: int, device) -> torch.Tensor:
    half = window // 2
    rows = (torch.arange(n_doy)[:, None]
            + torch.arange(-half, half + 1)[None, :]) % n_doy
    return rows.to(device)


def stage_plain(xg: torch.Tensor, q, window: int, stage: int,
                alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """Each stage's result by plain torch, on xg's device: 0 the number of
    valid samples of each (doy, cell) window as float32; 1 the window's
    smallest valid value (NaN without one); 2 the quantiles
    (:func:`doy_window_quantiles_plain`)."""
    _check(xg, window)
    if stage == 2:
        return doy_window_quantiles_plain(xg, q, window, alpha, beta)
    rows = _window_rows(xg.shape[0], window, xg.device)
    if stage == 0:
        per = (~torch.isnan(xg)).sum(dim=1, dtype=torch.int32)   # (n_doy, C)
        return per[rows].sum(dim=1).float()
    if stage == 1:
        per = torch.where(torch.isnan(xg), torch.inf, xg).amin(dim=1)
        lo = per[rows].amin(dim=1)
        has = (~torch.isnan(xg)).any(dim=1)[rows].any(dim=1)
        return torch.where(has, lo, torch.nan)
    raise ValueError(f"stage must be 0, 1 or 2, got {stage}")


def slide_counts(xg: torch.Tensor, window: int) -> torch.Tensor:
    """The valid values entering and leaving the windows at the kernel's
    slides, as an int64 pair on xg's device: at each doy g of a chunk
    (:func:`doy_chunks`) but its first, slice g + half enters and slice
    g - 1 - half leaves every cell's window; a chunk start sorts its
    window whole, and window 1 sorts every doy's, so neither counts."""
    n_doy, Y, C = xg.shape
    nchunk = doy_chunks(n_doy, C, window, Y)
    g = torch.arange(n_doy, device=xg.device)
    # doy g lies in chunk j where j * n_doy // nchunk <= g
    chunk = ((g + 1) * nchunk - 1) // n_doy
    slide = torch.zeros(n_doy, dtype=torch.int64, device=xg.device)
    if window > 1:
        slide[1:] = chunk[1:] == chunk[:-1]
    half = window // 2
    per = (~torch.isnan(xg)).sum(dim=(1, 2))          # valid values a doy
    return torch.stack([(per[(g + half) % n_doy] * slide).sum(),
                        (per[(g - 1 - half) % n_doy] * slide).sum()])


def doy_window_quantiles_plain(xg: torch.Tensor, q, window: int,
                               alpha: float = 1.0,
                               beta: float = 1.0) -> torch.Tensor:
    """Plain PyTorch twin: windowed gather + sort quantile, on xg's device.

    The windowed gather holds every sample ``window`` times (22 GB at 30
    years x 16384 cells), so cells go through in slabs whose gathered block
    stays under ~1 GB; the sort underneath allocates a few times that.
    While tracing, counts ``winquantile_inserted`` and
    ``winquantile_removed`` as the kernel does (:func:`slide_counts`).
    """
    _check(xg, window)
    n_doy, Y, C = xg.shape
    if profiling.active():
        count(COUNTERS[-2:], slide_counts(xg, window))
    rows = _window_rows(n_doy, window, xg.device).reshape(-1)
    qv = torch.as_tensor(q, dtype=torch.float32, device=xg.device)
    out = torch.empty((n_doy, len(qv), C), dtype=torch.float32,
                      device=xg.device)
    slab = max(1, min(C, _SLAB_BYTES // max(1, n_doy * window * Y * 4)))
    for c0 in range(0, C, slab):
        part = xg[:, :, c0:c0 + slab]
        g = part[rows].reshape(n_doy, window * Y, part.shape[-1])
        res = nan_quantile_plain(g, qv, axis=1, alpha=alpha, beta=beta)
        out[:, :, c0:c0 + slab] = res.movedim(0, 1)
    return out
