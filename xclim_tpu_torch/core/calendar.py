"""Calendar engine: CF-calendar datetime math, frequency parsing, resample segmentation.

All calendar logic runs host-side in vectorized numpy and produces *static
integer tables* (segment ids, gather indices, expected counts) that the
device code consumes as tensors. This replaces the reference's
cftime/pandas machinery (reference: src/xclim/core/calendar.py) without any
dynamic per-element Python. The array-level operations at the end
(``stack_periods``, ``convert_calendar``, ``mask_between_doys``, ...) apply
those tables to a ClimArray's tensor on its own device.

Supported CF calendars: standard / gregorian / proleptic_gregorian (treated as
proleptic Gregorian), julian, noleap / 365_day, all_leap / 366_day, 360_day.

Reference parity notes are cited as ``xclim:<file>:<line>`` throughout.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

__all__ = [
    "CALENDARS",
    "TimeIndex",
    "common_calendar",
    "compare_offsets",
    "construct_offset",
    "date_range",
    "date_to_ordinal",
    "day_of_year",
    "days_in_month",
    "days_in_year",
    "days_since_to_doy",
    "doy_from_string",
    "doy_to_days_since",
    "get_calendar",
    "is_leap_year",
    "max_doy",
    "ordinal_to_date",
    "parse_offset",
    "percentile_doy_table",
    "resample_segments",
    "select_time_mask",
    "SegmentSpec",
]

# ---------------------------------------------------------------------------
# Calendar basics
# ---------------------------------------------------------------------------

_CAL_ALIASES = {
    "standard": "standard",
    "gregorian": "standard",
    "proleptic_gregorian": "standard",
    "default": "standard",
    "julian": "julian",
    "noleap": "noleap",
    "365_day": "noleap",
    "all_leap": "all_leap",
    "366_day": "all_leap",
    "360_day": "360_day",
}

CALENDARS = ("standard", "julian", "noleap", "all_leap", "360_day")

_DAYS_IN_MONTH = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], dtype=np.int64)
_DAYS_IN_MONTH_LEAP = np.array([31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], dtype=np.int64)
_CUM_DAYS = np.concatenate([[0], np.cumsum(_DAYS_IN_MONTH)])  # 13 entries
_CUM_DAYS_LEAP = np.concatenate([[0], np.cumsum(_DAYS_IN_MONTH_LEAP)])

# max day-of-year per calendar (xclim: core/calendar.py uses max_doy mapping)
_MAX_DOY = {"standard": 366, "julian": 366, "all_leap": 366, "noleap": 365, "360_day": 360}

_MONTH_ABBR = ["", "JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP", "OCT", "NOV", "DEC"]


def normalize_calendar(calendar: str) -> str:
    try:
        return _CAL_ALIASES[str(calendar).lower()]
    except KeyError as err:
        raise ValueError(f"Unknown calendar: {calendar!r}") from err


def max_doy(calendar: str) -> int:
    """Maximum day-of-year for a calendar (366 standard, 365 noleap, 360 for 360_day)."""
    return _MAX_DOY[normalize_calendar(calendar)]


def is_leap_year(year, calendar: str = "standard"):
    """Vectorized leap-year predicate per CF calendar."""
    year = np.asarray(year, dtype=np.int64)
    cal = normalize_calendar(calendar)
    if cal == "standard":
        return (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))
    if cal == "julian":
        return year % 4 == 0
    if cal == "all_leap":
        return np.ones_like(year, dtype=bool)
    return np.zeros_like(year, dtype=bool)  # noleap, 360_day


def days_in_year(year, calendar: str = "standard"):
    cal = normalize_calendar(calendar)
    year = np.asarray(year, dtype=np.int64)
    if cal == "360_day":
        return np.full_like(year, 360)
    return np.where(is_leap_year(year, cal), 366, 365).astype(np.int64)


def days_in_month(year, month, calendar: str = "standard"):
    cal = normalize_calendar(calendar)
    year = np.asarray(year, dtype=np.int64)
    month = np.asarray(month, dtype=np.int64)
    if cal == "360_day":
        return np.full_like(month, 30)
    leap = is_leap_year(year, cal)
    base = _DAYS_IN_MONTH[month - 1]
    return np.where(leap & (month == 2), 29, base).astype(np.int64)


def day_of_year(year, month, day, calendar: str = "standard"):
    """1-based ordinal day within the year."""
    cal = normalize_calendar(calendar)
    year = np.asarray(year, dtype=np.int64)
    month = np.asarray(month, dtype=np.int64)
    day = np.asarray(day, dtype=np.int64)
    if cal == "360_day":
        return 30 * (month - 1) + day
    leap = is_leap_year(year, cal)
    return np.where(leap, _CUM_DAYS_LEAP[month - 1], _CUM_DAYS[month - 1]) + day


def date_to_ordinal(year, month, day, calendar: str = "standard"):
    """Days since 0001-01-01 (ordinal 1) in the given calendar. Vectorized."""
    cal = normalize_calendar(calendar)
    year = np.asarray(year, dtype=np.int64)
    doy = day_of_year(year, month, day, cal)
    y = year - 1
    if cal == "standard":
        return 365 * y + y // 4 - y // 100 + y // 400 + doy
    if cal == "julian":
        return 365 * y + y // 4 + doy
    if cal == "noleap":
        return 365 * y + doy
    if cal == "all_leap":
        return 366 * y + doy
    return 360 * y + doy  # 360_day


def _doy_to_month_day(year, doy, calendar):
    """Convert (year, 1-based doy) to (month, day). Vectorized."""
    cal = normalize_calendar(calendar)
    doy = np.asarray(doy, dtype=np.int64)
    if cal == "360_day":
        month = (doy - 1) // 30 + 1
        day = (doy - 1) % 30 + 1
        return month, day
    leap = is_leap_year(year, cal)
    cum = np.where(leap[..., None], _CUM_DAYS_LEAP[None, :], _CUM_DAYS[None, :])
    # month m such that cum[m-1] < doy <= cum[m]
    month = (doy[..., None] > cum).sum(axis=-1).astype(np.int64)
    day = doy - np.take_along_axis(cum, (month - 1)[..., None], axis=-1)[..., 0]
    return month, day


def ordinal_to_date(ordinal, calendar: str = "standard"):
    """Inverse of date_to_ordinal → (year, month, day). Vectorized."""
    cal = normalize_calendar(calendar)
    n = np.asarray(ordinal, dtype=np.int64)
    if cal == "360_day":
        y = (n - 1) // 360 + 1
        doy = n - 360 * (y - 1)
    elif cal == "noleap":
        y = (n - 1) // 365 + 1
        doy = n - 365 * (y - 1)
    elif cal == "all_leap":
        y = (n - 1) // 366 + 1
        doy = n - 366 * (y - 1)
    elif cal == "julian":
        # 4-year cycle = 1461 days
        c4, r = np.divmod(n - 1, 1461)
        yin = np.minimum(r // 365, 3)
        y = 4 * c4 + yin + 1
        doy = r - 365 * yin + 1
    else:  # proleptic gregorian: 400-year cycle = 146097 days
        c400, r = np.divmod(n - 1, 146097)
        c100 = np.minimum(r // 36524, 3)
        r = r - c100 * 36524
        c4 = r // 1461
        r = r - c4 * 1461
        c1 = np.minimum(r // 365, 3)
        doy = r - c1 * 365 + 1
        y = 400 * c400 + 100 * c100 + 4 * c4 + c1 + 1
    month, day = _doy_to_month_day(y, doy, cal)
    return y, month, day


# ---------------------------------------------------------------------------
# TimeIndex
# ---------------------------------------------------------------------------


@dataclass
class TimeIndex:
    """A calendar-aware time coordinate held host-side as integer component arrays.

    All device kernels receive only integer tables derived from this; the index
    itself never crosses to the device. Replaces xarray CFTimeIndex/DatetimeIndex.
    """

    year: np.ndarray
    month: np.ndarray
    day: np.ndarray
    hour: np.ndarray = None
    minute: np.ndarray = None
    second: np.ndarray = None
    calendar: str = "standard"

    def __post_init__(self):
        self.calendar = normalize_calendar(self.calendar)
        n = len(self.year)
        self.year = np.asarray(self.year, dtype=np.int64)
        self.month = np.asarray(self.month, dtype=np.int64)
        self.day = np.asarray(self.day, dtype=np.int64)
        for f in ("hour", "minute", "second"):
            v = getattr(self, f)
            setattr(self, f, np.zeros(n, dtype=np.int64) if v is None else np.asarray(v, dtype=np.int64))

    # -- basic protocol ----------------------------------------------------
    def __len__(self):
        return len(self.year)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            idx = slice(idx, idx + 1) if idx != -1 else slice(-1, None)
            ti = TimeIndex(self.year[idx], self.month[idx], self.day[idx],
                           self.hour[idx], self.minute[idx], self.second[idx], self.calendar)
            return ti
        return TimeIndex(self.year[idx], self.month[idx], self.day[idx],
                         self.hour[idx], self.minute[idx], self.second[idx], self.calendar)

    def __eq__(self, other):
        if not isinstance(other, TimeIndex):
            return NotImplemented
        return (self.calendar == other.calendar and len(self) == len(other)
                and bool(np.all(self.encode() == other.encode())))

    def __repr__(self):
        if len(self) == 0:
            return f"TimeIndex([], calendar={self.calendar})"
        return (f"TimeIndex({self.isoformat(0)}..{self.isoformat(-1)}, n={len(self)}, "
                f"calendar={self.calendar})")

    def isoformat(self, i: int) -> str:
        return (f"{self.year[i]:04d}-{self.month[i]:02d}-{self.day[i]:02d}"
                f"T{self.hour[i]:02d}:{self.minute[i]:02d}:{self.second[i]:02d}")

    # -- derived fields ----------------------------------------------------
    @property
    def ordinal(self) -> np.ndarray:
        """Days since 0001-01-01 == 1, in this calendar."""
        return date_to_ordinal(self.year, self.month, self.day, self.calendar)

    @property
    def doy(self) -> np.ndarray:
        return day_of_year(self.year, self.month, self.day, self.calendar)

    @property
    def dayofyear(self) -> np.ndarray:
        return self.doy

    @property
    def season(self) -> np.ndarray:
        """Meteorological season string per step (DJF/MAM/JJA/SON)."""
        return np.array(["DJF", "DJF", "MAM", "MAM", "MAM", "JJA", "JJA", "JJA",
                         "SON", "SON", "SON", "DJF"])[self.month - 1]

    @property
    def seconds_of_day(self) -> np.ndarray:
        return self.hour * 3600 + self.minute * 60 + self.second

    def encode(self) -> np.ndarray:
        """Seconds since 0001-01-01T00:00:00 in this calendar (int64). Total order."""
        return self.ordinal * 86400 + self.seconds_of_day

    @property
    def decimal_year(self) -> np.ndarray:
        """Fractional year (xclim: core/calendar.py uses decimal_year for detrending)."""
        start = date_to_ordinal(self.year, 1, 1, self.calendar)
        length = days_in_year(self.year, self.calendar).astype(np.float64)
        frac = (self.ordinal - start).astype(np.float64) + self.seconds_of_day / 86400.0
        return self.year + frac / length

    # -- freq inference ----------------------------------------------------
    def infer_freq(self) -> str | None:
        """Infer a frequency string (like pandas.infer_freq; xclim uses xr.infer_freq)."""
        if len(self) < 3:
            return None
        enc = self.encode()
        d = np.diff(enc)
        if np.all(d == d[0]):
            step = int(d[0])
            if step % 86400 == 0:
                days = step // 86400
                if days == 1:
                    return "D"
                return f"{days}D"
            if step % 3600 == 0:
                h = step // 3600
                return "h" if h == 1 else f"{h}h"
            if step % 60 == 0:
                m = step // 60
                return "min" if m == 1 else f"{m}min"
            return f"{step}s"
        # irregular in seconds: monthly / yearly style
        if np.all(self.day == self.day[0]) and np.all(self.seconds_of_day == self.seconds_of_day[0]):
            mi = self.year * 12 + (self.month - 1)
            dm = np.diff(mi)
            if np.all(dm == dm[0]):
                m = int(dm[0])
                anchor = _MONTH_ABBR[self.month[0]]
                if self.day[0] == 1:
                    if m == 1:
                        return "MS"
                    if m == 3:
                        # canonicalize quarter anchor: {DEC,MAR,JUN,SEP}→DEC etc.
                        qm = int(self.month[0]) % 3
                        anchor = {0: "DEC", 1: "JAN", 2: "FEB"}[qm]
                        return f"QS-{anchor}"
                    if m == 12:
                        return f"YS-{anchor}" if anchor != "JAN" else "YS"
                    if m % 12 == 0:
                        return f"{m // 12}YS" + ("" if anchor == "JAN" else f"-{anchor}")
                    return f"{m}MS"
        # month-end?
        dim = days_in_month(self.year, self.month, self.calendar)
        if np.all(self.day == dim):
            mi = self.year * 12 + (self.month - 1)
            dm = np.diff(mi)
            if np.all(dm == 1):
                return "ME"
            if np.all(dm == 12):
                return "YE" if self.month[0] == 12 else f"YE-{_MONTH_ABBR[self.month[0]]}"
        return None

    # -- conversion --------------------------------------------------------
    def convert_calendar(self, target: str) -> tuple["TimeIndex", np.ndarray]:
        """Map this index onto another calendar.

        Returns (new_index, keep_mask): dates that do not exist in the target
        calendar (Feb 29 → noleap) are dropped; keep_mask marks retained steps.
        Mirrors xclim/xarray ``convert_calendar(..., align_on="date")``.
        """
        target = normalize_calendar(target)
        if target == self.calendar:
            return self, np.ones(len(self), dtype=bool)
        if target == "360_day" or self.calendar == "360_day":
            # align_on="year": map doy proportionally (xclim core/calendar.py "360_day" handling)
            nd_src = days_in_year(self.year, self.calendar).astype(np.float64)
            nd_tgt = days_in_year(self.year, target).astype(np.float64)
            new_doy = np.minimum(np.round((self.doy - 0.5) / nd_src * nd_tgt + 0.5).astype(np.int64),
                                 nd_tgt.astype(np.int64))
            new_doy = np.maximum(new_doy, 1)
            month, day = _doy_to_month_day(self.year, new_doy, target)
            keep = np.ones(len(self), dtype=bool)
            # drop duplicated target dates
            enc = self.year * 1000 + new_doy
            keep[1:] = enc[1:] != enc[:-1]
            ti = TimeIndex(self.year[keep], month[keep], day[keep],
                           self.hour[keep], self.minute[keep], self.second[keep], target)
            return ti, keep
        valid = self.day <= days_in_month(self.year, self.month, target)
        ti = TimeIndex(self.year[valid], self.month[valid], self.day[valid],
                       self.hour[valid], self.minute[valid], self.second[valid], target)
        return ti, valid

    def to_datetime64(self) -> np.ndarray:
        """Convert to numpy datetime64[s]; only valid for the standard calendar."""
        if self.calendar != "standard":
            raise ValueError("Only the standard calendar converts to datetime64.")
        epoch = date_to_ordinal(1970, 1, 1, "standard")
        secs = (self.ordinal - epoch) * 86400 + self.seconds_of_day
        return secs.astype("datetime64[s]")

    @classmethod
    def from_datetime64(cls, arr: np.ndarray) -> "TimeIndex":
        arr = np.asarray(arr, dtype="datetime64[s]").astype(np.int64)
        epoch = date_to_ordinal(1970, 1, 1, "standard")
        ordinal = arr // 86400 + epoch
        sod = arr % 86400
        y, m, d = ordinal_to_date(ordinal, "standard")
        return cls(y, m, d, sod // 3600, (sod % 3600) // 60, sod % 60, "standard")

    @classmethod
    def from_cf(cls, values: np.ndarray, units: str, calendar: str = "standard") -> "TimeIndex":
        """Decode CF 'X since YYYY-MM-DD...' numeric time values."""
        m = re.match(
            r"\s*(\w+)\s+since\s+(-?\d{1,4})-(\d{1,2})-(\d{1,2})"
            r"(?:[T ](\d{1,2}):(\d{1,2}):(\d{1,2}(?:\.\d*)?))?", units)
        if not m:
            raise ValueError(f"Cannot parse CF time units: {units!r}")
        unit, y0, mo0, d0 = m.group(1).lower(), int(m.group(2)), int(m.group(3)), int(m.group(4))
        h0 = int(m.group(5) or 0)
        mi0 = int(m.group(6) or 0)
        s0 = float(m.group(7) or 0)
        per = {"days": 86400, "day": 86400, "d": 86400, "hours": 3600, "hour": 3600, "h": 3600,
               "minutes": 60, "minute": 60, "min": 60, "seconds": 1, "second": 1, "s": 1,
               "milliseconds": 1e-3, "millisecond": 1e-3, "ms": 1e-3}[unit]
        base = (date_to_ordinal(y0, mo0, d0, calendar) * 86400 + h0 * 3600 + mi0 * 60 + s0)
        secs = np.round(np.asarray(values, dtype=np.float64) * per + base).astype(np.int64)
        ordinal = secs // 86400
        sod = secs % 86400
        y, mo, d = ordinal_to_date(ordinal, calendar)
        return cls(y, mo, d, sod // 3600, (sod % 3600) // 60, sod % 60, calendar)

    def to_cf(self, units: str = "days since 1970-01-01") -> np.ndarray:
        m = re.match(r"\s*(\w+)\s+since\s+(-?\d{1,4})-(\d{1,2})-(\d{1,2})", units)
        unit, y0, mo0, d0 = m.group(1).lower(), int(m.group(2)), int(m.group(3)), int(m.group(4))
        per = {"days": 86400, "hours": 3600, "minutes": 60, "seconds": 1}[unit]
        base = date_to_ordinal(y0, mo0, d0, self.calendar) * 86400
        return (self.encode() - base) / per

    # -- timestep durations ------------------------------------------------
    def timestep_seconds(self) -> np.ndarray:
        """Duration of each timestep in seconds.

        For month-based sampling the exact calendar length of each period is
        used (so March gets 31 days); otherwise the forward diff (last value
        repeated). Used by rate↔amount conversions (xclim:core/units.py:854).
        """
        freq = self.infer_freq()
        if freq is not None:
            mult, base, is_start, anchor = parse_offset(freq)
            if base in ("M", "Q", "Y"):
                months_per = {"M": 1, "Q": 3, "Y": 12}[base] * mult
                mi = self.year * 12 + (self.month - 1)
                if not is_start:
                    mi = mi - months_per + 1  # period ends at this label
                y0, m0 = mi // 12, mi % 12 + 1
                mi1 = mi + months_per
                y1, m1 = mi1 // 12, mi1 % 12 + 1
                days = (date_to_ordinal(y1, m1, 1, self.calendar)
                        - date_to_ordinal(y0, m0, 1, self.calendar))
                return days.astype(np.float64) * 86400.0
        enc = self.encode()
        if len(enc) < 2:
            return np.array([86400.0] * len(enc))
        d = np.diff(enc).astype(np.float64)
        return np.concatenate([d, d[-1:]])


def get_calendar(obj) -> str:
    """Return the calendar name of a TimeIndex / array with time coord (xclim :138)."""
    if isinstance(obj, TimeIndex):
        return obj.calendar
    time = getattr(obj, "time", None)
    if isinstance(time, TimeIndex):
        return time.calendar
    if isinstance(obj, np.ndarray) and np.issubdtype(obj.dtype, np.datetime64):
        return "standard"
    raise ValueError(f"Cannot infer calendar from {type(obj)}")


def common_calendar(calendars, join="outer") -> str:
    """Pick a common calendar (xclim: core/calendar.py common_calendar)."""
    cals = {normalize_calendar(c) for c in calendars}
    if len(cals) == 1:
        return cals.pop()
    if join == "outer":
        if "standard" in cals:
            return "standard"
        if "all_leap" in cals:
            return "all_leap"
        if "noleap" in cals:
            return "noleap"
        return "360_day"
    # inner: least common denominator
    if "360_day" in cals:
        return "360_day"
    if "noleap" in cals:
        return "noleap"
    return "standard"


# ---------------------------------------------------------------------------
# date_range
# ---------------------------------------------------------------------------


def _parse_datestring(s: str):
    m = re.match(r"\s*(-?\d{1,4})(?:-(\d{1,2}))?(?:-(\d{1,2}))?"
                 r"(?:[T ](\d{1,2})(?::(\d{1,2}))?(?::(\d{1,2}))?)?", str(s))
    if not m:
        raise ValueError(f"Cannot parse date string {s!r}")
    g = [int(x) if x is not None else None for x in m.groups()]
    return g  # [y, m, d, H, M, S]


def date_range(start, periods=None, end=None, freq="D", calendar="standard") -> TimeIndex:
    """Generate a TimeIndex like pandas.date_range / xr.cftime_range."""
    cal = normalize_calendar(calendar)
    y, mo, d, H, Mi, S = _parse_datestring(start)
    mo = mo or 1
    d = d or 1
    H = H or 0
    Mi = Mi or 0
    S = S or 0
    mult, base, is_start, anchor = parse_offset(freq)
    if periods is None:
        if end is None:
            raise ValueError("Provide `periods` or `end`.")
        ye, moe, de, He, Mie, Se = _parse_datestring(end)
        moe = moe or 12
        de = de or int(days_in_month(ye, moe, cal))
        end_enc = date_to_ordinal(ye, moe, de, cal) * 86400 + (He or 0) * 3600 + (Mie or 0) * 60 + (Se or 0)
    else:
        end_enc = None

    if base in ("D", "W", "h", "min", "s"):
        step = {"D": 86400, "W": 7 * 86400, "h": 3600, "min": 60, "s": 1}[base] * mult
        start_enc = date_to_ordinal(y, mo, d, cal) * 86400 + H * 3600 + Mi * 60 + S
        if periods is None:
            periods = int((end_enc - start_enc) // step) + 1
        enc = start_enc + step * np.arange(periods, dtype=np.int64)
        ordinal = enc // 86400
        sod = enc % 86400
        yy, mm, dd = ordinal_to_date(ordinal, cal)
        return TimeIndex(yy, mm, dd, sod // 3600, (sod % 3600) // 60, sod % 60, cal)

    # month-based offsets
    months_per = {"M": 1, "Q": 3, "Y": 12}[base] * mult
    if periods is None:
        approx = (end_enc // 86400 - date_to_ordinal(y, mo, d, cal)) / 28.0
        periods = int(approx // months_per) + 3
        trim = True
    else:
        trim = False
    if is_start:
        # roll forward to the next anchor-aligned period start (pandas behavior)
        anchor_m = _month_anchor_num(anchor, 1) if base in ("Y", "Q") else 1
        mi0 = y * 12 + (mo - 1)
        period_len = {"M": 1, "Q": 3, "Y": 12}[base]
        off = (mi0 - (anchor_m - 1)) % period_len
        if off != 0 or d > 1:
            if off != 0:
                mi0 += period_len - off
            elif d > 1:
                mi0 += period_len
            y = mi0 // 12
            mo = mi0 % 12 + 1
            d = 1
    mi0 = y * 12 + (mo - 1)
    mi = mi0 + months_per * np.arange(periods, dtype=np.int64)
    yy = mi // 12
    mm = mi % 12 + 1
    if is_start:
        dd = np.minimum(d, days_in_month(yy, mm, cal))
    else:  # end-anchored: last day of month
        dd = days_in_month(yy, mm, cal)
    ti = TimeIndex(yy, mm, dd, np.full(periods, H), np.full(periods, Mi), np.full(periods, S), cal)
    if trim:
        keep = ti.encode() <= end_enc
        return ti[keep]
    return ti


# ---------------------------------------------------------------------------
# Offsets (frequency strings)
# ---------------------------------------------------------------------------

_OFFSET_RE = re.compile(r"^(\d*)(YS|YE|AS|A|Y|QS|QE|Q|MS|ME|M|W|D|h|H|min|T|s|S)(?:-(\w{3,4}))?$")
_BASE_MAP = {"YS": ("Y", True), "YE": ("Y", False), "AS": ("Y", True), "A": ("Y", False),
             "Y": ("Y", False), "QS": ("Q", True), "QE": ("Q", False), "Q": ("Q", False),
             "MS": ("M", True), "ME": ("M", False), "M": ("M", False),
             "W": ("W", True), "D": ("D", True), "h": ("h", True), "H": ("h", True),
             "min": ("min", True), "T": ("min", True), "s": ("s", True), "S": ("s", True)}


def parse_offset(freq: str) -> tuple[int, str, bool, str | None]:
    """Parse a frequency string → (multiplier, base, is_start_anchored, anchor).

    Mirrors xclim ``parse_offset`` (core/calendar.py:558): base is one of
    Y/Q/M/W/D/h/min/s; anchor is a month abbreviation (Y/Q) or weekday (W).
    """
    m = _OFFSET_RE.match(freq.strip())
    if not m:
        raise ValueError(f"Cannot parse frequency: {freq!r}")
    mult = int(m.group(1) or 1)
    base, is_start = _BASE_MAP[m.group(2)]
    anchor = m.group(3)
    if anchor is None and base == "Y":
        anchor = "JAN" if is_start else "DEC"
    if anchor is None and base == "Q":
        anchor = "JAN" if is_start else "DEC"
    return mult, base, is_start, anchor


def construct_offset(mult: int, base: str, start: bool, anchor: str | None) -> str:
    """Inverse of parse_offset (xclim core/calendar.py:599)."""
    code = {("Y", True): "YS", ("Y", False): "YE", ("Q", True): "QS", ("Q", False): "QE",
            ("M", True): "MS", ("M", False): "ME", ("W", True): "W", ("W", False): "W",
            ("D", True): "D", ("D", False): "D", ("h", True): "h", ("h", False): "h",
            ("min", True): "min", ("s", True): "s"}[(base, start)]
    s = (str(mult) if mult > 1 else "") + code
    if anchor and base in ("Y", "Q", "W"):
        default = {"Y": "JAN" if start else "DEC", "Q": "JAN" if start else "DEC", "W": None}[base]
        if anchor != default:
            s += f"-{anchor}"
    return s


_APPROX_SECONDS = {"Y": 365.25 * 86400, "Q": 365.25 / 4 * 86400, "M": 30.44 * 86400,
                   "W": 7 * 86400, "D": 86400, "h": 3600, "min": 60, "s": 1}


def freq_seconds(freq: str) -> float:
    """Approximate seconds per period of freq (for offset comparison)."""
    mult, base, _, _ = parse_offset(freq)
    return mult * _APPROX_SECONDS[base]


def compare_offsets(freqA: str, op: str, freqB: str) -> bool:
    """Compare two frequencies by period length (xclim core/calendar.py compare_offsets)."""
    a, b = freq_seconds(freqA), freq_seconds(freqB)
    import operator

    return {"<": operator.lt, "<=": operator.le, ">": operator.gt, ">=": operator.ge,
            "==": operator.eq, "!=": operator.ne}[op](a, b)


def _month_anchor_num(anchor: str | None, default: int = 1) -> int:
    if anchor is None:
        return default
    try:
        return _MONTH_ABBR.index(anchor.upper()[:3])
    except ValueError as err:
        raise ValueError(f"Unknown month anchor {anchor!r}") from err


# ---------------------------------------------------------------------------
# Resample segmentation — the core static table generator
# ---------------------------------------------------------------------------


@dataclass
class SegmentSpec:
    """Static description of a resample(freq) grouping over a time axis.

    Everything a device kernel needs: per-step segment ids (monotone
    non-decreasing ints in [0, nseg)), per-segment counts, per-segment expected
    counts from calendar math (for missing masks, xclim core/missing.py:64),
    and the label TimeIndex for the output time coordinate.
    """

    freq: str
    seg_id: np.ndarray          # (T,) int32
    nseg: int
    counts: np.ndarray          # (nseg,) int32 — actual steps present
    expected: np.ndarray        # (nseg,) int32 — steps a complete period would have
    labels: TimeIndex           # (nseg,) period start (or end for *E freqs)
    starts: np.ndarray = None   # (nseg,) int32 — index of first step of each segment
    # uniform reshape fast path: set when every segment has the same count
    uniform: int | None = None

    def __post_init__(self):
        if self.starts is None:
            self.starts = np.searchsorted(self.seg_id, np.arange(self.nseg)).astype(np.int32)
        if len(self.counts) and self.counts.min() == self.counts.max():
            self.uniform = int(self.counts[0])


def _period_index(time: TimeIndex, freq: str):
    """Integer period number for each timestep under freq, plus a function to
    build the period-start label from a period number."""
    mult, base, is_start, anchor = parse_offset(freq)
    cal = time.calendar
    if base in ("Y", "Q", "M"):
        anchor_m = _month_anchor_num(anchor, 1) if base in ("Y", "Q") else 1
        if base == "Y" and not is_start:
            # YE-DEC: years end in Dec → period starts month after anchor
            anchor_m = anchor_m % 12 + 1
        if base == "Q" and not is_start:
            anchor_m = anchor_m % 12 + 1
        months_per = {"M": 1, "Q": 3, "Y": 12}[base] * mult
        mi = time.year * 12 + (time.month - 1) - (anchor_m - 1)
        pidx = mi // months_per

        def label_for(p):
            mi0 = p * months_per + (anchor_m - 1)
            yy = mi0 // 12
            mm = mi0 % 12 + 1
            if is_start:
                return yy, mm, np.ones_like(yy)
            # end label: last month of period, last day
            mi1 = mi0 + months_per - 1
            yy1 = mi1 // 12
            mm1 = mi1 % 12 + 1
            return yy1, mm1, days_in_month(yy1, mm1, cal)

        def expected_steps(p, step_seconds):
            mi0 = p * months_per + (anchor_m - 1)
            yy = mi0 // 12
            mm = mi0 % 12 + 1
            mi1 = mi0 + months_per
            yy1 = mi1 // 12
            mm1 = mi1 % 12 + 1
            ndays = (date_to_ordinal(yy1, mm1, 1, cal) - date_to_ordinal(yy, mm, 1, cal))
            return np.round(ndays * 86400 / step_seconds).astype(np.int64)

        return pidx, label_for, expected_steps

    step = {"W": 7 * 86400, "D": 86400, "h": 3600, "min": 60, "s": 1}[base] * mult
    enc = time.encode()
    if base == "W":
        # anchor weekly periods on the weekday; 0001-01-01 is a Monday in the
        # proleptic Gregorian calendar. pandas W-XXX = weeks ending on XXX.
        wd_anchor = {"MON": 0, "TUE": 1, "WED": 2, "THU": 3, "FRI": 4, "SAT": 5, "SUN": 6}
        endday = wd_anchor.get((anchor or "SUN").upper(), 6)
        startday = (endday + 1) % 7
        off0 = 86400 + startday * 86400  # ordinal day 1 (=Monday) encodes to 86400
    else:
        # anchor at the first step's day start (pandas origin='start_day')
        off0 = int(enc[0] // 86400 * 86400)
    pidx = (enc - off0) // step

    def label_for(p):
        enc0 = p * step + off0
        ordv = enc0 // 86400
        sod = enc0 % 86400
        yy, mm, dd = ordinal_to_date(ordv, cal)
        return (yy, mm, dd, sod // 3600, (sod % 3600) // 60, sod % 60)

    def expected_steps(p, step_seconds):
        return np.full(len(np.atleast_1d(p)), int(round(step / step_seconds)), dtype=np.int64)

    return pidx, label_for, expected_steps


def resample_segments(time: TimeIndex, freq: str) -> SegmentSpec:
    """Build the SegmentSpec for resample(time=freq) over this index."""
    pidx, label_for, expected_steps = _period_index(time, freq)
    if np.any(np.diff(pidx) < 0):
        raise ValueError("Time axis must be sorted for resampling.")
    uniq = np.unique(pidx)
    seg_id = np.searchsorted(uniq, pidx).astype(np.int32)
    nseg = len(uniq)
    counts = np.bincount(seg_id, minlength=nseg).astype(np.int32)
    step_seconds = float(np.median(np.diff(time.encode()))) if len(time) > 1 else 86400.0
    expected = expected_steps(uniq, step_seconds).astype(np.int32)
    lab = label_for(uniq)
    if len(lab) == 3:
        labels = TimeIndex(lab[0], lab[1], lab[2], calendar=time.calendar)
    else:
        labels = TimeIndex(lab[0], lab[1], lab[2], lab[3], lab[4], lab[5], calendar=time.calendar)
    return SegmentSpec(freq=freq, seg_id=seg_id, nseg=nseg, counts=counts,
                       expected=expected, labels=labels)


# ---------------------------------------------------------------------------
# Time selection (indexer) — xclim core/calendar.py:1259 select_time
# ---------------------------------------------------------------------------


def doy_from_string(doy_str: str, calendar: str = "standard") -> int:
    """'MM-DD' → day-of-year (non-leap reference year; xclim DayOfYearStr)."""
    mm, dd = (int(x) for x in doy_str.split("-"))
    return int(day_of_year(1999 if normalize_calendar(calendar) != "all_leap" else 2000, mm, dd,
                           calendar))


def select_time_mask(
    time: TimeIndex,
    drop: bool = False,
    season: str | list[str] | None = None,
    month: int | list[int] | None = None,
    doy_bounds: tuple[int, int] | None = None,
    date_bounds: tuple[str, str] | None = None,
    include_bounds: bool | tuple[bool, bool] = True,
) -> np.ndarray:
    """Boolean mask of timesteps selected by the indexer (xclim select_time :1259).

    At most one of season/month/doy_bounds/date_bounds may be given. Bounds may
    wrap around the end of the year.
    """
    n_given = sum(x is not None for x in (season, month, doy_bounds, date_bounds))
    if n_given == 0:
        return np.ones(len(time), dtype=bool)
    if n_given > 1:
        raise ValueError("Only one time-selection criterion may be given.")
    if season is not None:
        seasons = [season] if isinstance(season, str) else list(season)
        return np.isin(time.season, seasons)
    if month is not None:
        months = [month] if isinstance(month, (int, np.integer)) else list(month)
        return np.isin(time.month, months)
    if isinstance(include_bounds, bool):
        include_bounds = (include_bounds, include_bounds)
    if doy_bounds is not None:
        lo, hi = doy_bounds
        doy = time.doy
        lo_ok = (doy >= lo) if include_bounds[0] else (doy > lo)
        hi_ok = (doy <= hi) if include_bounds[1] else (doy < hi)
        return (lo_ok & hi_ok) if lo <= hi else (lo_ok | hi_ok)
    # date_bounds: 'MM-DD' strings. Compare (month, day) keys directly — a
    # doy conversion is wrong in half the years of a mixed leap/non-leap
    # calendar (e.g. '12-25' mapped via a noleap doy selects Dec 24 in leap
    # years).
    lo_s, hi_s = date_bounds

    def _md_key(s: str) -> int:
        mm, dd = s.split("-")
        return int(mm) * 100 + int(dd)

    lo = _md_key(lo_s)
    hi = _md_key(hi_s)
    key = time.month * 100 + time.day
    lo_ok = (key >= lo) if include_bounds[0] else (key > lo)
    hi_ok = (key <= hi) if include_bounds[1] else (key < hi)
    return (lo_ok & hi_ok) if lo <= hi else (lo_ok | hi_ok)


# ---------------------------------------------------------------------------
# doy <-> days-since helpers (xclim core/calendar.py:1004,:1075)
# ---------------------------------------------------------------------------


def doy_to_days_since(doy_vals: np.ndarray, years: np.ndarray, start_doy: int,
                      calendar: str = "standard") -> np.ndarray:
    """Convert day-of-year values (one per year) to days since `start_doy` of that year."""
    ndays = days_in_year(years, calendar).astype(np.float64)
    out = np.asarray(doy_vals, dtype=np.float64) - start_doy
    return np.where(out < 0, out + ndays, out)


def days_since_to_doy(days: np.ndarray, years: np.ndarray, start_doy: int,
                      calendar: str = "standard") -> np.ndarray:
    """Inverse of :func:`doy_to_days_since`."""
    ndays = days_in_year(years, calendar).astype(np.float64)
    out = np.asarray(days, dtype=np.float64) + start_doy
    return np.where(out > ndays, out - ndays, out)


# ---------------------------------------------------------------------------
# percentile_doy gather table (xclim core/calendar.py:396 percentile_doy)
# ---------------------------------------------------------------------------


def percentile_doy_table(time: TimeIndex, window: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Static gather table for day-of-year climatological percentiles.

    For each day-of-year d (1..max_doy present) the reference takes a centred
    rolling window of `window` days and groups by doy over all years
    (xclim core/calendar.py:443-483); here that is one static gather.

    Returns
    -------
    table : int32 (n_doy, n_years * window)
        Indices into the time axis, year-major then window offset; -1 marks
        missing samples (series edges, absent leap days), which the quantile
        treats as NaN.
    doys : int32 (n_doy,)
        The day-of-year value of each row.
    """
    if window % 2 != 1:
        raise ValueError("window must be odd")
    half = window // 2
    n = len(time)
    cal = time.calendar
    years = np.unique(time.year)
    doys = np.arange(1, max_doy(cal) + 1, dtype=np.int64)
    doys = doys[np.isin(doys, np.unique(time.doy))]

    # position lookup: ordinal -> index (daily data)
    ords = time.ordinal
    o0 = ords[0]
    pos = np.full(int(ords[-1] - o0 + 1), -1, dtype=np.int64)
    pos[ords - o0] = np.arange(n)

    # centre ordinal of each (doy, year); -1 where the doy does not exist that
    # year (366 in a common year)
    dy = doys[:, None]
    yr = years[None, :]
    valid = dy <= days_in_year(yr, cal)
    start_of_year = date_to_ordinal(yr, 1, np.ones_like(yr), cal)
    center = np.where(valid, start_of_year + dy - 1, -(10**9))
    offs = np.arange(-half, half + 1, dtype=np.int64)
    tgt = center[:, :, None] + offs[None, None, :]  # (n_doy, n_years, window)
    inrange = (tgt >= o0) & (tgt <= ords[-1]) & valid[:, :, None]
    idx = np.where(inrange, tgt - o0, 0)
    table = np.where(inrange, pos[idx], -1)
    table = np.where(table >= 0, table, -1)
    return table.reshape(len(doys), -1).astype(np.int32), doys.astype(np.int32)


# ---------------------------------------------------------------------------
# period stacking (xclim core/calendar.py:1396 stack_periods / :1598 unstack)
# ---------------------------------------------------------------------------


def stack_periods_table(time: TimeIndex, window: int = 30, stride: int | None = None,
                        min_length: int | None = None, freq: str = "YS"):
    """Static gather table for stacking `window`-period slices along a new
    'period' axis (the reference's stack_periods, core/calendar.py:1396).

    Returns (table, period_starts): table (n_periods, max_len) int32 indices
    into the time axis (-1 padded), and the TimeIndex of period starts.
    """
    stride = stride or window
    min_length = min_length or window
    spec = resample_segments(time, freq)
    n = spec.nseg
    periods = []
    p_idx = []
    for i0 in range(0, n, stride):
        i1 = i0 + window
        if i1 > n:
            if (n - i0) < min_length:
                break
            i1 = n
        if (i1 - i0) < min_length:
            continue
        s = int(spec.starts[i0])
        e = int(spec.starts[i1 - 1] + spec.counts[i1 - 1])
        periods.append((s, e))
        p_idx.append(i0)
    if not periods:
        raise ValueError("No complete periods found.")
    maxlen = max(e - s for s, e in periods)
    table = np.full((len(periods), maxlen), -1, dtype=np.int32)
    for k, (s, e) in enumerate(periods):
        table[k, : e - s] = np.arange(s, e, dtype=np.int32)
    return table, spec.labels[np.asarray(p_idx)]


def _labels(lab, calendar) -> TimeIndex:
    if len(lab) == 3:
        return TimeIndex(lab[0], lab[1], lab[2], calendar=calendar)
    return TimeIndex(*lab, calendar=calendar)


def time_bnds(time: TimeIndex, freq: str | None = None):
    """(start, end) bounds of each timestep's period (xclim
    core/calendar.py:793): two TimeIndex of len(time), the start of the
    step's period and the start of the next one."""
    if freq is None:
        freq = time.infer_freq()
        if freq is None:
            raise ValueError("Cannot infer freq for time_bnds.")
    pidx, label_for, _ = _period_index(time, freq)
    uniq, inv = np.unique(pidx, return_inverse=True)
    lo = _labels(label_for(uniq), time.calendar)
    hi = _labels(label_for(uniq + 1), time.calendar)
    return lo[inv], hi[inv]


def climatological_mean_doy(arr, time: TimeIndex, window: int = 5):
    """Mean and standard deviation (ddof 0) per day of year over a centred
    `window`-day window of every year (xclim core/calendar.py:907), time on
    axis 0. A tensor gives tensors on its device; a numpy array is
    computed on ``default_device()`` and gives numpy arrays, as the
    reference's host function does."""
    import torch

    from xclim_tpu_torch.core.dataarray import _tensor

    table, _ = percentile_doy_table(time, window=window)
    host = not isinstance(arr, torch.Tensor)
    x = _tensor(np.asarray(arr)) if host else arr
    idx = torch.as_tensor(table, device=x.device)
    flat = idx.reshape(-1).clamp(min=0).long()
    g = x.index_select(0, flat).reshape(idx.shape + x.shape[1:])
    valid = (idx >= 0).reshape(idx.shape + (1,) * (x.ndim - 1))
    g = torch.where(valid, g, torch.nan)
    mu = torch.nanmean(g, dim=1)
    sd = torch.sqrt(torch.nanmean((g - mu.unsqueeze(1)) ** 2, dim=1))
    return (mu.cpu().numpy(), sd.cpu().numpy()) if host else (mu, sd)


# ---------------------------------------------------------------------------
# public array-level calendar operations
# (xclim core/calendar.py:1166 mask_between_doys, :1396 stack_periods,
#  :1598 unstack_periods; xarray-level convert_calendar)
# ---------------------------------------------------------------------------


def _along_time(values, da):
    """A (T,) host or device vector shaped to broadcast along da's time
    axis, on da's device."""
    import torch

    shape = [1] * da.ndim
    shape[da.time_axis] = len(da.time)
    return torch.as_tensor(values, device=da.data.device).reshape(shape)


def mask_between_doys(da, doy_bounds, include_bounds=(True, True)):
    """Boolean mask of steps inside day-of-year bounds
    (xclim core/calendar.py:1166).

    `doy_bounds` may be a pair of ints (possibly wrapping the year end) or a
    pair of ClimArrays (or tensors) of per-cell bounds without a time dim,
    in da's order of the other dims. Returns a ClimArray of bools on `da`'s
    dims and device (a host mask when `da` is a TimeIndex).
    """
    import torch

    from xclim_tpu_torch.core.dataarray import ClimArray, _tensor

    time = da.time if isinstance(da, ClimArray) else da
    start, end = doy_bounds
    if isinstance(start, (int, np.integer)) and isinstance(end, (int, np.integer)):
        m = select_time_mask(time, doy_bounds=(int(start), int(end)),
                             include_bounds=include_bounds)
        if not isinstance(da, ClimArray):
            return m
        return ClimArray(_along_time(m, da).expand(da.shape), da.dims,
                         dict(da.coords), {}, "mask")
    if not isinstance(da, ClimArray):
        raise TypeError("Array bounds require a ClimArray input.")
    sv, ev = (_tensor(getattr(b, "data", b), like=da.data)
              for b in (start, end))
    sv = torch.where(torch.isnan(sv), 1.0, sv)
    ev = torch.where(torch.isnan(ev), float(max_doy(time.calendar)), ev)
    if not include_bounds[0]:
        sv = sv + 1
    if not include_bounds[1]:
        ev = ev - 1
    doy = _along_time(time.doy.astype(np.float32), da)
    other = [1 if d == "time" else s for d, s in zip(da.dims, da.shape)]
    svb = sv.reshape(other) if sv.ndim else sv
    evb = ev.reshape(other) if ev.ndim else ev
    inside = torch.where(svb > evb, (doy >= svb) | (doy <= evb),
                         (doy >= svb) & (doy <= evb))
    return ClimArray(inside.expand(da.shape), da.dims, dict(da.coords), {},
                     "mask")


def stack_periods(da, window: int = 30, stride: int | None = None,
                  min_length: int | None = None, freq: str = "YS"):
    """Stack (possibly overlapping) `window`-period slices of `da` on a new
    leading 'period' dimension (xclim core/calendar.py:1396).

    One static gather table gives a fixed (n_periods, max_len) layout, NaN
    padded; the inverse mapping is kept in ``coords['_stack']`` for
    :func:`unstack_periods`.
    """
    import torch

    from xclim_tpu_torch.core.dataarray import ClimArray

    table, starts = stack_periods_table(da.time, window=window, stride=stride,
                                        min_length=min_length, freq=freq)
    ax = da.time_axis
    x = torch.movedim(da.data, ax, 0)
    tbl = torch.as_tensor(table, device=x.device)
    g = x.index_select(0, tbl.reshape(-1).clamp(min=0).long()).reshape(
        tbl.shape + x.shape[1:])
    mask = (tbl >= 0).reshape(tbl.shape + (1,) * (x.ndim - 1))
    g = torch.movedim(torch.where(mask, g, torch.nan), 1, ax + 1)
    coords = {k: v for k, v in da.coords.items() if k != "time"}
    coords["period"] = starts
    coords["_stack"] = {"table": table, "time": da.time,
                        "stride": stride or window, "window": window}
    return ClimArray(g, ("period",) + da.dims, coords, dict(da.attrs), da.name)


def unstack_periods(da, dim: str = "period"):
    """Invert :func:`stack_periods` (xclim core/calendar.py:1598).

    For overlapping windows (stride < window) each timestep takes its value
    from the last period that holds it, as the reference does when
    reconstructing from overlapping climatological windows.
    """
    import torch

    from xclim_tpu_torch.core.dataarray import ClimArray

    info = da.coords.get("_stack")
    if info is None:
        raise ValueError("Input was not produced by stack_periods.")
    table: np.ndarray = info["table"]
    time: TimeIndex = info["time"]
    pax = da.dims.index(dim)
    x = torch.movedim(da.data, pax, 0)
    tax = da.dims.index("time") - (1 if pax < da.dims.index("time") else 0)
    x = torch.movedim(x, tax + 1, 1)  # (period, slot, ...)
    # the last period holding a step owns it; with stride == window it is
    # the only one
    owner = np.full(len(time), -1, dtype=np.int64)
    slot = np.zeros(len(time), dtype=np.int64)
    for p in range(table.shape[0]):
        valid = table[p] >= 0
        owner[table[p][valid]] = p
        slot[table[p][valid]] = np.nonzero(valid)[0]
    keep = owner >= 0
    gathered = x[torch.as_tensor(owner[keep], device=x.device),
                 torch.as_tensor(slot[keep], device=x.device)]
    out_dims = tuple(d for d in da.dims if d != dim)
    coords = {k: v for k, v in da.coords.items() if k not in (dim, "_stack")}
    coords["time"] = time[keep]
    return ClimArray(torch.movedim(gathered, 0, out_dims.index("time")),
                     out_dims, coords, dict(da.attrs), da.name)


def convert_calendar(da, target: str, align_on: str = "date", missing=None):
    """Convert a ClimArray's time coordinate to another calendar
    (xarray ``convert_calendar`` / xclim core/calendar.py docs).

    Dates absent from the target calendar (Feb 29 -> noleap) are dropped;
    with ``missing`` set, dates of the target calendar absent from the
    source are inserted filled with ``missing`` (at the source's inferred
    frequency, else daily). 360_day conversions map the day of year
    proportionally (``align_on='year'``) whatever ``align_on`` says.
    """
    import torch

    from xclim_tpu_torch.core.dataarray import ClimArray

    time = da.time
    new_time, keep = time.convert_calendar(target)
    ax = da.time_axis
    x = torch.movedim(da.data, ax, 0)
    x = x.index_select(0, torch.as_tensor(np.nonzero(keep)[0], device=x.device))
    if missing is not None:
        freq = time.infer_freq() or "D"
        full = date_range(new_time.isoformat(0),
                          end=new_time.isoformat(len(new_time) - 1),
                          freq=freq, calendar=target)
        lookup = {int(e): i for i, e in enumerate(full.encode())}
        idx = np.array([lookup[int(e)] for e in new_time.encode()],
                       dtype=np.int64)
        filled = torch.full((len(full),) + x.shape[1:], float(missing),
                            dtype=x.dtype, device=x.device)
        x = filled.index_copy(0, torch.as_tensor(idx, device=x.device), x)
        new_time = full
    coords = dict(da.coords)
    coords["time"] = new_time
    return ClimArray(torch.movedim(x, 0, ax), da.dims, coords,
                     dict(da.attrs), da.name)


# ---------------------------------------------------------------------------
# public aliases & small API helpers (reference export parity,
# xclim core/calendar.py)
# ---------------------------------------------------------------------------

#: Type alias for 'MM-DD' day-of-year strings (xclim DayOfYearStr)
DayOfYearStr = str

#: Calendars with a constant year length (xclim core/calendar.py:108)
uniform_calendars = ("noleap", "all_leap", "365_day", "366_day", "360_day")


def ensure_cftime_array(time):
    """Normalize a time axis to a TimeIndex, which plays the role of a
    cftime array here (xclim core/calendar.py)."""
    if isinstance(time, TimeIndex):
        return time
    arr = np.asarray(time)
    if np.issubdtype(arr.dtype, np.datetime64):
        return TimeIndex.from_datetime64(arr)
    raise TypeError(f"Cannot interpret {type(time)} as a time index.")


def is_offset_divisor(divisor: str, offset: str) -> bool:
    """Whether a whole number of `divisor` periods fit in one `offset` period
    (xclim core/calendar.py:629)."""
    mult_d, base_d, _, _ = parse_offset(divisor)
    mult_o, base_o, _, _ = parse_offset(offset)
    order = {"s": 0, "min": 1, "h": 2, "D": 3, "W": 4, "M": 5, "Q": 6, "Y": 7}
    bd = {"T": "min", "H": "h"}.get(base_d, base_d)
    bo = {"T": "min", "H": "h"}.get(base_o, base_o)
    if order[bd] > order[bo]:
        return False
    if bd in ("W", "M", "Q", "Y") or bo in ("W", "M", "Q", "Y"):
        # calendar-based: month-multiple logic
        months = {"M": 1, "Q": 3, "Y": 12}
        if bd in months and bo in months:
            return (months[bo] * mult_o) % (months[bd] * mult_d) == 0
        if bd == "W":
            return bo == "W" and mult_o % mult_d == 0
        # a fixed sub-month divisor divides any month-based period only if
        # it divides a day
        return freq_seconds(divisor) <= 86400 and \
            (86400 % freq_seconds(divisor) == 0)
    return freq_seconds(offset) % freq_seconds(divisor) == 0


def within_bnds_doy(arr, *, low, high):
    """True where values lie within per-doy bounds (xclim
    core/calendar.py:934). `low`/`high` have a leading 'dayofyear' dim;
    they are gathered onto arr's time axis (axis 0)."""
    import torch

    from xclim_tpu_torch.core.dataarray import ClimArray, _tensor

    doy = arr.time.doy.astype(np.int64)

    def _on_time(b):
        bd = _tensor(getattr(b, "data", b), like=arr.data)
        doys = np.asarray(b.coords["dayofyear"]) if isinstance(b, ClimArray) \
            else np.arange(1, bd.shape[0] + 1)
        pos = np.clip(np.searchsorted(doys, doy), 0, len(doys) - 1)
        bd = bd.index_select(0, torch.as_tensor(pos, device=bd.device))
        return bd.reshape(bd.shape + (1,) * (arr.ndim - bd.ndim))

    out = (arr.data >= _on_time(low)) & (arr.data <= _on_time(high))
    return ClimArray(out, arr.dims, dict(arr.coords), {}, "within_bnds")


def convert_doy(source, target_cal: str, source_cal: str | None = None,
                align_on: str = "year"):
    """Convert day-of-year values between calendars (xclim
    core/calendar.py convert_doy): proportional mapping of the doy onto the
    target calendar's year length. A ClimArray with a time axis maps each
    year by its own lengths; anything else by the calendars' longest year
    (``source_cal`` defaults to standard)."""
    from xclim_tpu_torch.core.dataarray import ClimArray, _tensor

    is_da = isinstance(source, ClimArray)
    vals = source.data if is_da else _tensor(source)
    if is_da and source.time is not None:
        years = source.time.year
        src_cal = source_cal or source.time.calendar
        nd_src = _along_time(days_in_year(years, src_cal).astype(np.float32),
                             source)
        nd_tgt = _along_time(days_in_year(years, target_cal).astype(np.float32),
                             source)
    else:
        nd_src = float(max_doy(source_cal or "standard"))
        nd_tgt = float(max_doy(target_cal))
    new = (vals - 0.5) / nd_src * nd_tgt + 0.5
    if not is_da:
        return new
    out = source.copy(data=new)
    out.attrs["calendar"] = normalize_calendar(target_cal)
    return out


def split_time_to_season_year(da, freq: str = "QS-DEC"):
    """Reshape a quarterly series onto ('year', 'season') dims (xclim
    core/calendar.py split_time_to_season_year); December counts toward
    the next year's DJF."""
    import torch

    from xclim_tpu_torch.core.dataarray import ClimArray

    labels = da.time
    year = labels.year + (labels.month == 12).astype(np.int64)
    seasons = np.array(["DJF", "MAM", "JJA", "SON"])
    years = np.unique(year)
    tbl = np.full((len(years), 4), -1, dtype=np.int64)
    # DJF, MAM, JJA, SON = 0..3
    tbl[np.searchsorted(years, year), labels.month % 12 // 3] = \
        np.arange(len(labels))
    data = torch.movedim(da.data, da.dims.index("time"), 0)
    idx = torch.as_tensor(tbl, device=data.device)
    g = data.index_select(0, idx.reshape(-1).clamp(min=0)).reshape(
        idx.shape + data.shape[1:])
    g = torch.where((idx >= 0).reshape(idx.shape + (1,) * (data.ndim - 1)),
                    g, torch.nan)
    space_dims = tuple(d for d in da.dims if d != "time")
    coords = {k: v for k, v in da.coords.items() if k in space_dims}
    return ClimArray(g, ("year", "season") + space_dims,
                     {"year": years, "season": seasons, **coords},
                     dict(da.attrs), da.name)


def add_season_coord(da):
    """Attach a 'season' coordinate derived from the time axis (xclim
    core/calendar.py add_season_coord)."""
    out = da.copy()
    out.coords["season"] = da.time.season
    return out


def select_time(da, drop: bool = False, **indexer):
    """Select (or mask) the timesteps matched by the indexer: the function
    form of ``ClimArray.select_time`` (xclim core/calendar.py:1259)."""
    return da.select_time(drop=drop, **indexer)


#: the doy-climatology functions the reference re-exports from core.calendar
#: (xclim core/calendar.py:396-907); they live in core/percentiles.py, which
#: imports this module, so they are looked up on first use
_FROM_PERCENTILES = ("adjust_doy_calendar", "build_climatology_bounds",
                     "percentile_doy", "resample_doy")


def __getattr__(name):
    if name in _FROM_PERCENTILES:
        from xclim_tpu_torch.core import percentiles

        return getattr(percentiles, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
