"""Grouper: static group tables for bias adjustment
(reference: the xsdba package's Grouper — xclim.sdba re-exports it;
xclim:src/xclim/sdba.py:1-28, docs/sdba.rst).

A Grouper turns ``group='time.dayofyear', window=31`` into two static integer
tables computed host-side:

* a *training* gather table (n_groups, max_samples) collecting every time step
  whose (windowed) day-of-year / month / season matches the group;
* an *adjust* mapping: for each time step, its group id and the step's slot in
  the group (to scatter per-group results back onto the time axis with one
  gather).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from xclim_tpu_torch.core.calendar import TimeIndex, max_doy
from xclim_tpu_torch.utils.profiling import span

__all__ = ["Grouper"]

_SEASON_OF_MONTH = np.array([0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 0])  # DJF=0...


@dataclass
class Grouper:
    """Grouping of time steps for adjustment training (xsdba Grouper).

    Parameters
    ----------
    group : {"time", "time.month", "time.season", "time.dayofyear"}
        Grouping dimension.
    window : int
        Odd number of days around each day-of-year to include in training
        (only for time.dayofyear; reference default 1, north-star config 31).
    """

    group: str = "time"
    window: int = 1

    def __post_init__(self):
        if isinstance(self.group, Grouper):
            other = self.group
            self.group = other.group
            self.window = other.window
        if self.group not in ("time", "time.month", "time.season", "time.dayofyear"):
            raise ValueError(f"Unsupported group {self.group!r}")
        if self.window % 2 != 1:
            raise ValueError("window must be odd")

    @property
    def prop(self) -> str:
        return self.group.split(".")[-1] if "." in self.group else "group"

    def n_groups(self, time: TimeIndex) -> int:
        if self.group == "time":
            return 1
        if self.group == "time.month":
            return 12
        if self.group == "time.season":
            return 4
        return max_doy(time.calendar)

    def group_of_step(self, time: TimeIndex) -> np.ndarray:
        """(T,) int32 group id per time step."""
        if self.group == "time":
            return np.zeros(len(time), dtype=np.int32)
        if self.group == "time.month":
            return (time.month - 1).astype(np.int32)
        if self.group == "time.season":
            return _SEASON_OF_MONTH[time.month - 1].astype(np.int32)
        return (time.doy - 1).astype(np.int32)

    def train_table(self, time: TimeIndex) -> np.ndarray:
        """(n_groups, max_samples) int32 gather table, -1 padded.

        For ``time.dayofyear`` the window widens each group with the
        neighbouring doys (wrapping around the year)."""
        G = self.n_groups(time)
        T = len(time)
        gid = self.group_of_step(time)
        if self.group == "time.dayofyear" and self.window > 1:
            half = self.window // 2
            mx = max_doy(time.calendar)
            # member[g] = steps with doy in [g+1-half, g+1+half] (wrapped)
            doy0 = gid  # 0-based doy
            rows = []
            counts = np.zeros(G, dtype=np.int64)
            # offsets trick: step with doy d belongs to groups d-half..d+half
            offs = np.arange(-half, half + 1)
            gg = (doy0[None, :] + offs[:, None]) % mx  # (window, T)
            flat_g = gg.reshape(-1)
            flat_t = np.tile(np.arange(T, dtype=np.int32), self.window)
            order = np.argsort(flat_g, kind="stable")
            flat_g = flat_g[order]
            flat_t = flat_t[order]
            counts = np.bincount(flat_g, minlength=G)
            maxs = int(counts.max()) if len(counts) else 0
            table = np.full((G, maxs), -1, dtype=np.int32)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            within = np.arange(len(flat_g)) - starts[flat_g]
            table[flat_g, within] = flat_t
            return table
        counts = np.bincount(gid, minlength=G)
        maxs = int(counts.max()) if len(counts) else 0
        table = np.full((G, maxs), -1, dtype=np.int32)
        order = np.argsort(gid, kind="stable")
        sg = gid[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(T) - starts[sg]
        table[sg, within] = order.astype(np.int32)
        return table

    def doy_table(self, time: TimeIndex) -> np.ndarray:
        """(n_doy, max_occurrences) int32 time-index per (doy, occurrence),
        -1 padded; occurrences in chronological order.

        The doy-slice layout feeds the windowed-quantile training kernel
        (ops/winquantile.py), which reads each window's slices from it
        instead of gathering every step ``window`` times (the reference
        materializes the windowed construct —
        xclim:src/xclim/core/calendar.py:428-447 rolling construct)."""
        doy0 = (time.doy - 1).astype(np.int64)
        G = max_doy(time.calendar)
        counts = np.bincount(doy0, minlength=G)
        ms = int(counts.max()) if len(counts) else 0
        table = np.full((G, ms), -1, dtype=np.int32)
        order = np.argsort(doy0, kind="stable")
        sg = doy0[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(len(time)) - starts[sg]
        table[sg, within] = order.astype(np.int32)
        return table

    # -- device-resident tables --------------------------------------------
    # Built once per distinct (grouper, time index, device) and reused by
    # every train/adjust call on that time axis.

    def device_doy_table(self, time: TimeIndex, device) -> torch.Tensor:
        """doy_table as an int64 tensor on ``device``."""
        return self._cached(b"doy", time, device,
                            lambda: _dev(self.doy_table(time), device))

    def device_train_table(self, time: TimeIndex, device) -> torch.Tensor:
        """train_table as an int64 tensor on ``device``."""
        return self._cached(b"train", time, device,
                            lambda: _dev(self.train_table(time), device))

    def device_group_of_step(self, time: TimeIndex, device) -> torch.Tensor:
        """group_of_step as an int64 tensor on ``device``."""
        return self._cached(b"gid", time, device,
                            lambda: _dev(self.group_of_step(time), device))

    def device_adjust_table(self, time: TimeIndex, device):
        """(table, gid, flat_pos) as int64 tensors on ``device``."""
        return self._cached(
            b"adjust", time, device,
            lambda: tuple(_dev(a, device) for a in self.adjust_table(time)))

    def _time_key(self, time: TimeIndex) -> bytes:
        import hashlib

        h = hashlib.sha1()
        h.update(f"{self.group}|{self.window}|{time.calendar}".encode())
        h.update(time.year.tobytes())
        h.update(time.month.tobytes())
        h.update(time.day.tobytes())
        return h.digest()

    def _cached(self, kind: bytes, time: TimeIndex, device, build):
        with span("sdba.tables"):
            cache = getattr(self, "_device_tables", None)
            if cache is None:
                cache = {}
                object.__setattr__(self, "_device_tables", cache)
            key = (kind, self._time_key(time), str(torch.device(device)))
            if key not in cache:
                cache[key] = build()
            return cache[key]

    def adjust_table(self, time: TimeIndex) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Tables to process per-group then scatter back to the time axis.

        Returns (table, gid, flat_pos): table (n_groups, max_steps) gathers sim
        steps per group (no window); gid (T,); flat_pos (T,) such that
        ``out_time = res_flat[flat_pos]`` where res_flat = res.reshape(G*ms, ...).
        """
        G = self.n_groups(time)
        T = len(time)
        gid = self.group_of_step(time)
        counts = np.bincount(gid, minlength=G)
        ms = int(counts.max()) if len(counts) else 0
        table = np.full((G, ms), -1, dtype=np.int32)
        order = np.argsort(gid, kind="stable")
        sg = gid[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(T) - starts[sg]
        table[sg, within] = order.astype(np.int32)
        flat_pos = np.empty(T, dtype=np.int32)
        flat_pos[order] = sg * ms + within
        return table, gid.astype(np.int32), flat_pos


def _dev(table: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(table.astype(np.int64), device=device)
