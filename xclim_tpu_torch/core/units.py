"""CF units engine: parsing, algebra, conversion, dimensionality declarations.

A from-scratch, dependency-free replacement for the reference's pint/cf-xarray
registry (xclim:src/xclim/core/units.py). Units are represented as
(scale, offset, dimension-vector) triples plus a symbolic form for CF-style
printing ("kg m-2 s-1"). The hydro context (mass-of-water ↔ depth,
xclim:core/units.py:84-108) is built in.

All conversion factors are plain Python floats applied host-side to the
data tensor — there is never a unit object on the device.
"""

from __future__ import annotations

import contextlib
import functools
import re
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

__all__ = [
    "Quantity",
    "Units",
    "amount2lwethickness",
    "amount2rate",
    "cf_conversion",
    "check_units",
    "convert_units_to",
    "declare_units",
    "declare_relative_units",
    "ensure_absolute_temperature",
    "ensure_cf_units",
    "ensure_delta",
    "flux2rate",
    "infer_context",
    "infer_sampling_units",
    "lwethickness2amount",
    "pint_multiply",
    "pint2cfattrs",
    "pint2cfunits",
    "rate2amount",
    "rate2flux",
    "str2pint",
    "to_agg_units",
    "units",
    "units2pint",
]

# dimension symbols: L length, M mass, T time, K temperature, A angle, N amount(mol)
_DIMS = ("L", "M", "T", "K", "A", "N")

WATER_DENSITY = 1000.0  # kg m-3 (xclim:core/units.py:90)


def _dv(**kw) -> tuple:
    """Dimension vector as canonical tuple of Fractions over _DIMS."""
    return tuple(Fraction(kw.get(d, 0)) for d in _DIMS)


_ZERO_DIM = _dv()
_DENSITY_DIM = _dv(M=1, L=-3)


from xclim_tpu_torch.core._exceptions import ValidationError as _ValidationError


class UnitError(_ValidationError):
    """Raised for undefined units or incompatible dimensionalities
    (stand-in for pint.UndefinedUnitError / DimensionalityError; subclasses
    ValidationError because the reference's check_units raises it,
    xclim:core/units.py:1289)."""


# symbol → (scale_to_SI, offset_to_SI, dims, canonical_symbol)
_UNIT_TABLE: dict[str, tuple[float, float, tuple, str]] = {}


def _def(symbols, scale, dims, offset=0.0, canon=None):
    syms = symbols.split()
    canon = canon or syms[0]
    for s in syms:
        _UNIT_TABLE[s] = (float(scale), float(offset), dims, canon)


_def("m meter meters metre metres", 1.0, _dv(L=1))
_def("g gram grams gramme grammes", 1e-3, _dv(M=1))
_def("s sec secs second seconds", 1.0, _dv(T=1))
_def("min minute minutes", 60.0, _dv(T=1))
_def("h hr hrs hour hours", 3600.0, _dv(T=1))
_def("d day days", 86400.0, _dv(T=1), canon="d")
_def("week weeks wk", 604800.0, _dv(T=1), canon="week")
# mean Gregorian month, as in pint's default registry (year/12)
_def("month months mon", 365.25 * 86400 / 12, _dv(T=1), canon="month")
_def("yr year years a annum", 365.25 * 86400, _dv(T=1), canon="yr")
_def("K kelvin Kelvin kelvins degK deg_K", 1.0, _dv(K=1))
_def("degC celsius Celsius C deg_C degreeC degree_C degrees_C centigrade "
     "degrees_Celsius degree_Celsius °C ℃", 1.0, _dv(K=1),
     offset=273.15, canon="degC")
_def("degF fahrenheit Fahrenheit deg_F degreeF degree_F degrees_F "
     "degrees_Fahrenheit °F", 5.0 / 9.0, _dv(K=1),
     offset=459.67 * 5.0 / 9.0, canon="degF")
_def("delta_degC delta_celsius", 1.0, _dv(K=1), canon="delta_degC")
_def("delta_degF delta_fahrenheit", 5.0 / 9.0, _dv(K=1), canon="delta_degF")
# angles are dimensionless (pint convention, radian = 1)
_def("rad radian radians", 1.0, _ZERO_DIM)
_def("degree degrees deg degrees_north degrees_east °", np.pi / 180.0, _ZERO_DIM,
     canon="degree")
_def("mol mole moles", 1.0, _dv(N=1))
_def("Pa pascal pascals", 1.0, _dv(M=1, L=-1, T=-2))
_def("bar", 1e5, _dv(M=1, L=-1, T=-2))
_def("atm atmosphere", 101325.0, _dv(M=1, L=-1, T=-2))
_def("N newton newtons", 1.0, _dv(M=1, L=1, T=-2))
_def("J joule joules", 1.0, _dv(M=1, L=2, T=-2))
_def("W watt watts", 1.0, _dv(M=1, L=2, T=-3))
_def("Hz hertz", 1.0, _dv(T=-1))
_def("L l liter liters litre litres", 1e-3, _dv(L=3), canon="L")
_def("t tonne tonnes ton", 1e3, _dv(M=1), canon="t")
_def("cal calorie calories", 4.184, _dv(M=1, L=2, T=-2), canon="cal")
_def("%", 0.01, _ZERO_DIM, canon="%")
_def("percent pct", 0.01, _ZERO_DIM, canon="%")
_def("1", 1.0, _ZERO_DIM, canon="1")
_def("count", 1.0, _ZERO_DIM, canon="1")
_def("dimensionless", 1.0, _ZERO_DIM, canon="1")
_def("ppm", 1e-6, _ZERO_DIM, canon="ppm")
_def("knot knots kt", 0.514444, _dv(L=1, T=-1), canon="knot")
_def("mph", 0.44704, _dv(L=1, T=-1))
_def("inch inches in", 0.0254, _dv(L=1), canon="in")
_def("foot feet ft", 0.3048, _dv(L=1), canon="ft")

_PREFIXES = {
    "Y": 1e24, "Z": 1e21, "E": 1e18, "P": 1e15, "T": 1e12, "G": 1e9, "M": 1e6,
    "k": 1e3, "h": 1e2, "da": 1e1, "d": 1e-1, "c": 1e-2, "m": 1e-3,
    "u": 1e-6, "µ": 1e-6, "n": 1e-9, "p": 1e-12, "f": 1e-15,
}

# tokens that must never be parsed as prefix+unit
_NO_PREFIX_SPLIT = {"min", "in", "ft", "pct", "atm", "mph", "day", "days", "deg", "mol", "Pa", "yr", "percent", "count"}


def _resolve_symbol(tok: str) -> tuple[float, float, tuple, str]:
    if tok in _UNIT_TABLE:
        return _UNIT_TABLE[tok]
    if tok not in _NO_PREFIX_SPLIT:
        for plen in (2, 1):
            if len(tok) > plen and tok[:plen] in _PREFIXES and tok[plen:] in _UNIT_TABLE:
                sc, off, dims, canon = _UNIT_TABLE[tok[plen:]]
                if off != 0.0:
                    break  # no prefixed offset units
                pre = tok[:plen]
                return sc * _PREFIXES[pre], 0.0, dims, pre + canon
    raise UnitError(f"Undefined unit symbol: {tok!r}")


_TOKEN_RE = re.compile(r"([A-Za-zµ°%℃_]+)(?:\s*(?:\*\*|\^)\s*)?([+-]?\d+)?")


@dataclass(frozen=True)
class Units:
    """An immutable unit: scale & offset to SI plus dimension vector, and a
    symbolic composition for CF printing."""

    scale: float
    offset: float  # nonzero only for lone temperature units
    dims: tuple  # Fractions over _DIMS
    symbols: tuple  # sorted tuple of (canonical symbol, Fraction exponent)
    delta: bool = False  # temperature expressed as a difference

    # ---- algebra ----
    def __mul__(self, other: "Units") -> "Units":
        return Units(self.scale * other.scale, 0.0,
                     tuple(a + b for a, b in zip(self.dims, other.dims)),
                     _merge_symbols(self.symbols, other.symbols, 1))

    def __truediv__(self, other: "Units") -> "Units":
        return Units(self.scale / other.scale, 0.0,
                     tuple(a - b for a, b in zip(self.dims, other.dims)),
                     _merge_symbols(self.symbols, other.symbols, -1))

    def __pow__(self, p) -> "Units":
        p = Fraction(p)
        return Units(self.scale ** float(p), 0.0,
                     tuple(d * p for d in self.dims),
                     tuple((s, e * p) for s, e in self.symbols if e * p != 0))

    @property
    def dimensionality(self) -> tuple:
        return self.dims

    @property
    def is_temperature(self) -> bool:
        return self.dims == _dv(K=1)

    def to_cf(self) -> str:
        return _format_symbols(self.symbols)

    def __str__(self):
        return self.to_cf()

    def __format__(self, spec):
        return self.to_cf()


def _merge_symbols(a, b, sign):
    d = dict(a)
    for s, e in b:
        d[s] = d.get(s, Fraction(0)) + sign * e
    return tuple(sorted((s, e) for s, e in d.items() if e != 0))


def _fmt_exp(e: Fraction) -> str:
    if e.denominator == 1:
        return str(e.numerator)
    return f"{e.numerator}/{e.denominator}"


def _format_symbols(symbols) -> str:
    if not symbols:
        return "1"
    # order: positive exponents first, then negative (CF style: kg m-2 s-1)
    pos = [(s, e) for s, e in symbols if e > 0]
    neg = [(s, e) for s, e in symbols if e < 0]
    parts = []
    for s, e in pos + neg:
        if e == 1:
            parts.append(s)
        else:
            parts.append(f"{s}{_fmt_exp(e)}")
    out = " ".join(parts)
    return out if out else "1"


DIMENSIONLESS = Units(1.0, 0.0, _ZERO_DIM, ())


@functools.lru_cache(maxsize=4096)
def parse_units(s) -> Units:
    """Parse a CF unit string ('kg m-2 s-1', 'mm/day', 'degC', 'W/m^2', '%')."""
    if isinstance(s, Units):
        return s
    if s is None:
        return DIMENSIONLESS
    s = str(s).strip()
    if s in ("", "1", "dimensionless", "no_unit", "none"):
        return DIMENSIONLESS
    # split on '/' — pint semantics: a/b/c == a/(b)/(c)
    groups = re.split(r"/", s)
    scale = 1.0
    dims = list(_ZERO_DIM)
    symbols: tuple = ()
    n_units = 0
    last_offset = 0.0
    last_dims = None
    for gi, grp in enumerate(groups):
        sign = 1 if gi == 0 else -1
        # normalize '**' exponents to '^' BEFORE single '*' becomes a
        # multiplication separator ('kg/m**2/s' must keep m's exponent);
        # parentheses are group separators under the a/b/c == a/(b)/(c) rule
        grp = (grp.replace("**", "^").replace("·", " ").replace("*", " ")
               .replace("(", " ").replace(")", " "))
        # numeric scalars with a decimal point or scientific notation
        # ('0.5', '1E6', '2.5e-3') must be consumed BEFORE '.' is treated as
        # a multiplication separator and before tokenizing (else the exponent
        # marker reads as a unit symbol)
        def _num(m, _sign=sign):
            nonlocal scale
            scale *= float(m.group(0)) ** _sign
            return " "

        grp = re.sub(r"(?<![\w.])\d+\.?\d*[eE][+-]?\d+(?![\w.])|"
                     r"(?<![\w.])\d+\.\d+(?![\w.])", _num, grp)
        grp = grp.replace(".", " ")
        for m in _TOKEN_RE.finditer(grp):
            tok, exp = m.group(1), m.group(2)
            e = Fraction(int(exp) if exp is not None else 1) * sign
            sc, off, dvec, canon = _resolve_symbol(tok)
            scale *= sc ** float(e)
            dims = [a + b * e for a, b in zip(dims, dvec)]
            symbols = _merge_symbols(symbols, ((canon, e),), 1)
            n_units += 1
            last_offset = off
            last_dims = dvec
        # bare numbers (like "100") — treat as scale; strip unit tokens (and
        # their exponents) first so "s-1" doesn't contribute a stray 1
        residue = _TOKEN_RE.sub(" ", grp)
        for m in re.finditer(r"(\d+(?:\.\d+)?(?:e-?\d+)?)", residue):
            v = float(m.group(1))
            if v != 1:
                scale *= v ** sign
    offset = 0.0
    delta = False
    if n_units == 1 and last_dims == _dv(K=1) and tuple(dims) == _dv(K=1):
        offset = last_offset
        delta = symbols and symbols[0][0].startswith("delta_")
    return Units(scale, offset, tuple(dims), symbols, delta=bool(delta))


@dataclass(frozen=True)
class Quantity:
    """A magnitude with units (host-side scalar or numpy array)."""

    magnitude: float
    units: Units

    @property
    def m(self):
        return self.magnitude

    @property
    def u(self):
        return self.units

    def to(self, target, context: str | None = None) -> "Quantity":
        tgt = parse_units(target)
        factor, delta = _conversion(self.units, tgt, context)
        return Quantity(self.magnitude * factor + delta, tgt)

    @property
    def dimensionality(self):
        return self.units.dims

    def __str__(self):
        return f"{self.magnitude} {self.units.to_cf()}"

    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.magnitude * other.magnitude, self.units * other.units)
        return Quantity(self.magnitude * other, self.units)

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.magnitude / other.magnitude, self.units / other.units)
        return Quantity(self.magnitude / other, self.units)


#: stack of contexts enabled via ``with units.context(...)`` — consulted by
#: ``_conversion`` whenever no explicit context is passed, mirroring pint's
#: enabled-context semantics the reference relies on
#: (xclim:indices/_threshold.py:830,2927 wrap spell calls in
#: ``with units.context("hydro")``).
_ACTIVE_CONTEXTS: list[str] = []


class _Registry:
    """Minimal pint-registry lookalike: ``units.Quantity("5 mm/d")`` etc."""

    @staticmethod
    def Quantity(value, unit=None):
        if unit is None:
            if isinstance(value, str):
                return str2pint(value)
            return Quantity(value, DIMENSIONLESS)
        return Quantity(value, parse_units(unit))

    def __call__(self, s):
        return parse_units(s)

    def parse_units(self, s):
        return parse_units(s)

    @staticmethod
    @contextlib.contextmanager
    def context(name: str):
        """pint-style enabled-context block: conversions inside use `name`
        when no explicit context is given (xclim:core/units.py:442)."""
        _ACTIVE_CONTEXTS.append(str(name))
        try:
            yield
        finally:
            _ACTIVE_CONTEXTS.pop()


def _default_context() -> str | None:
    """Innermost ``units.context(...)`` block's context, or None."""
    ctx = _ACTIVE_CONTEXTS[-1] if _ACTIVE_CONTEXTS else None
    return None if ctx in (None, "none") else ctx


units = _Registry()


_Q_RE = re.compile(
    r"^\s*([+-]?(?:\d*\.?\d+(?:[eE][+-]?\d+)?"
    r"|[nN][aA][nN](?=[\s*/]|$)"
    r"|[iI][nN][fF](?:inity)?(?=[\s*/]|$)))?\s*(.*)$"
)


def str2pint(val) -> Quantity:
    """'30 degC' → Quantity (xclim:core/units.py str2pint). NaN/inf
    magnitudes parse like pint's ('nan m^2 K^-3')."""
    if isinstance(val, Quantity):
        return val
    if isinstance(val, (int, float)):
        return Quantity(float(val), DIMENSIONLESS)
    m = _Q_RE.match(str(val))
    mag = float(m.group(1)) if m.group(1) else 1.0
    return Quantity(mag, parse_units(m.group(2)))


def units2pint(obj) -> Units:
    """Extract Units from a ClimArray / string / Quantity (xclim units2pint)."""
    if isinstance(obj, Units):
        return obj
    if isinstance(obj, Quantity):
        return obj.units
    if isinstance(obj, str):
        return parse_units(obj)
    attrs = getattr(obj, "attrs", None)
    if attrs is not None:
        u = parse_units(attrs.get("units", ""))
        if (attrs.get("units_metadata") == "temperature: difference"
                and u.dims == _dv(K=1) and not u.delta):
            # CF marks temperature differences via units_metadata; carry that
            # into the delta flag so pint2cfattrs round-trips it
            # (xclim:tests/test_units.py test_temp_difference_rountrip)
            u = Units(u.scale, 0.0, u.dims, u.symbols, delta=True)
        return u
    raise UnitError(f"Cannot get units from {type(obj)}")


def pint2cfunits(u: Units) -> str:
    return parse_units(u).to_cf() if not isinstance(u, Units) else u.to_cf()


def pint2cfattrs(u: Units, is_difference: bool | None = None) -> dict:
    """Units → CF attrs dict, incl. units_metadata for temperature differences
    (xclim:core/units.py:226)."""
    attrs = {"units": u.to_cf().replace("delta_", "")}
    if u.dims == _dv(K=1) and (is_difference or u.delta):
        attrs["units_metadata"] = "temperature: difference"
    return attrs


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


def _conversion(src: Units, tgt: Units, context: str | None = None) -> tuple[float, float]:
    """Return (factor, delta) such that x_tgt = x_src * factor + delta."""
    if src.dims == tgt.dims:
        factor = src.scale / tgt.scale
        delta = (src.offset - tgt.offset) / tgt.scale
        return factor, delta
    if context is None:
        context = _default_context()  # enabled via `with units.context(...)`
    if context == "hydro":
        diff = tuple(a - b for a, b in zip(src.dims, tgt.dims))
        if diff == _DENSITY_DIM:  # mass/area[/time] → length[/time]: divide by density
            return src.scale / tgt.scale / WATER_DENSITY, 0.0
        if diff == tuple(-d for d in _DENSITY_DIM):
            return src.scale / tgt.scale * WATER_DENSITY, 0.0
    raise UnitError(
        f"Cannot convert from {src.to_cf()!r} {src.dims} to {tgt.to_cf()!r} {tgt.dims}"
        + (f" in context {context!r}" if context else "")
    )


def infer_context(standard_name: str | None = None, dimension: str | None = None) -> str:
    """Pick 'hydro' when the variable smells like liquid-water mass flux —
    reference-exact name set (xclim:core/units.py:1502-1542: the three exact
    evaporation names plus rainfall/lwe/precipitation/surface_snow_amount
    substrings; notably ``snowfall_flux`` is NOT hydro there)."""
    sn_hydro = standard_name is not None and (
        standard_name in (
            "water_potential_evapotranspiration_flux",
            "canopy_water_amount",
            "water_evaporation_amount",
        )
        or "rainfall" in standard_name
        or "lwe" in standard_name
        or "precipitation" in standard_name
        or "surface_snow_amount" in standard_name
    )
    dim_hydro = dimension is not None and (
        "[precipitation]" in dimension or "[snowamount]" in dimension)
    return "hydro" if (sn_hydro or dim_hydro) else "none"


def convert_units_to(source, target, context: str | None = None):
    """Convert a ClimArray / Quantity / quantified string to target units
    (xclim:core/units.py:334).

    For ClimArrays the data tensor is scaled on its own device and the units attr
    becomes the target's CF form.

    The hydro context (mass of water ↔ thickness) is **opt-in**, matching the
    reference: it applies only with ``context="hydro"``, or with
    ``context="infer"`` when the source's or target's ``standard_name``
    identifies a water quantity (xclim:core/units.py:380-397). With
    ``context=None`` an implicit mass↔length conversion raises
    :class:`UnitError` — *except* for ClimArray sources whose own
    ``standard_name`` is hydro, mirroring the reference's automatic CF
    conversions (amount2lwethickness family, xclim:core/units.py:414-436),
    which fire on standard_name regardless of context.
    """
    from xclim_tpu_torch.core.dataarray import ClimArray  # local import to avoid cycle

    if isinstance(target, (ClimArray,)):
        tgt = units2pint(target)
    else:
        tgt = parse_units(target) if not isinstance(target, Units) else target

    if context == "infer":
        ctxs = set()
        if hasattr(source, "attrs"):
            ctxs.add(infer_context(source.attrs.get("standard_name")))
        if hasattr(target, "attrs"):
            ctxs.add(infer_context(target.attrs.get("standard_name")))
        context = "hydro" if "hydro" in ctxs else None

    if isinstance(source, str):
        source = str2pint(source)
    if isinstance(source, (int, float)):
        source = Quantity(float(source), tgt)  # bare numbers: assume target units
        return source.magnitude
    if isinstance(source, Quantity):
        return source.to(tgt, context).magnitude

    # ClimArray
    src = units2pint(source)
    if context is None and src.dims != tgt.dims:
        # reference's automatic CF conversions: a water standard_name on the
        # source licenses the mass↔thickness bridge even without a context
        if infer_context(source.attrs.get("standard_name")) == "hydro":
            context = "hydro"
    factor, delta = _conversion(src, tgt, context)
    data = source.data
    if factor != 1.0 or delta != 0.0:
        data = data * factor + delta if delta != 0.0 else data * factor
    new = source.copy(data=data)
    new.attrs = dict(source.attrs)
    new.attrs["units"] = tgt.to_cf().replace("delta_", "")
    if tgt.delta:
        new.attrs["units_metadata"] = "temperature: difference"
    return new


def _hydro_compatible(a: Units, b: Units) -> bool:
    diff = tuple(x - y for x, y in zip(a.dims, b.dims))
    return diff == _DENSITY_DIM or diff == tuple(-d for d in _DENSITY_DIM)


# ---------------------------------------------------------------------------
# Dimensionality declarations
# ---------------------------------------------------------------------------

_NAMED_DIMENSIONS = {
    "length": _dv(L=1),
    "area": _dv(L=2),
    "volume": _dv(L=3),
    "mass": _dv(M=1),
    "time": _dv(T=1),
    "temperature": _dv(K=1),
    "speed": _dv(L=1, T=-1),
    "velocity": _dv(L=1, T=-1),
    "acceleration": _dv(L=1, T=-2),
    "pressure": _dv(M=1, L=-1, T=-2),
    "energy": _dv(M=1, L=2, T=-2),
    "power": _dv(M=1, L=2, T=-3),
    "radiation": _dv(M=1, T=-3),  # W m-2 (xclim:core/units.py:80)
    "precipitation": _dv(M=1, L=-2, T=-1),  # kg m-2 s-1 (xclim:core/units.py:77)
    "snowamount": _dv(M=1, L=-2),  # kg m-2 (xclim:core/units.py:78)
    "discharge": _dv(L=3, T=-1),  # m3 s-1 (xclim:core/units.py:79)
    "angle": _dv(A=1),
    "dimensionless": _ZERO_DIM,
    "": _ZERO_DIM,
}

_HYDRO_NAMES = {"precipitation", "snowamount"}


def _parse_dimensionality(decl: str) -> tuple[tuple, bool]:
    """'[precipitation]', '[length]/[time]', '[]' → (dim vector, hydro_flexible).

    Parenthesized sub-expressions are accepted inside the expression —
    ``'(mm)/[time]'``, ``'(mm/day)'``, ``'([temperature])'`` — which is how
    ``declare_relative_units`` declarations read after composition
    (xclim:core/units.py:1313-1380). Groups are extracted *before* the '/'
    split so slashes inside a group keep their meaning, and a group may
    itself contain bracketed dimension names (resolved recursively)."""
    decl = decl.strip()
    if decl in ("[]", ""):
        return _ZERO_DIM, False
    hydro = False
    # Pre-extract parenthesized groups into placeholder names so the
    # outer '/'-split can't cut through them; nested declarations recurse.
    group_dims: dict[str, tuple] = {}

    def _sub(m: re.Match) -> str:
        nonlocal hydro
        lit = m.group(1)
        if "[" in lit:
            vec, h = _parse_dimensionality(lit)
            hydro = hydro or h
        else:
            vec = parse_units(lit).dims
        key = f"__group{len(group_dims)}__"
        group_dims[key] = vec
        return f"[{key}]{m.group(2) or ''}"

    decl_flat = re.sub(r"\(([^()]+)\)(\s*(?:\*\*|\^)\s*[+-]?\d+)?", _sub, decl)

    dims = list(_ZERO_DIM)
    parts = decl_flat.split("/")
    for gi, grp in enumerate(parts):
        sgn = 1 if gi == 0 else -1
        for m in re.finditer(
                r"\[(\w*)\](?:\s*(?:\*\*|\^)\s*([+-]?\d+))?", grp):
            name, exp = m.group(1), int(m.group(2) or 1)
            vec = group_dims.get(name)
            if vec is None:
                vec = _NAMED_DIMENSIONS.get(name)
                if vec is None:
                    raise UnitError(
                        f"Unknown dimensionality name [{name}] in {decl!r}")
                if name in _HYDRO_NAMES:
                    hydro = True
            dims = [a + b * sgn * exp for a, b in zip(dims, vec)]
    return tuple(dims), hydro


def check_units(val, dim: str | None) -> None:
    """Validate that `val`'s units have dimensionality `dim`
    (xclim:core/units.py check_units). Raises UnitError otherwise."""
    if dim is None or val is None:
        return
    if str(dim) in ("[]", ""):
        expected, hydro = _ZERO_DIM, False
    elif "[" not in str(dim) and "(" not in str(dim):
        # literal unit string declaration, e.g. declare_units(sum_thresh="K days")
        expected, hydro = parse_units(str(dim)).dims, False
    else:
        expected, hydro = _parse_dimensionality(str(dim))
    u = units2pint(val) if not isinstance(val, (int, float)) else DIMENSIONLESS
    if u.dims == expected:
        return
    if hydro:
        diff = tuple(a - b for a, b in zip(u.dims, expected))
        if diff in (_DENSITY_DIM, tuple(-d for d in _DENSITY_DIM)):
            return
    # dimensionless declared: accept % etc (dims zero already); accept count
    raise UnitError(
        f"Units {u.to_cf()!r} (dims {u.dims}) do not match expected dimensionality {dim!r}"
    )


def declare_units(**units_by_name):
    """Attach expected dimensionalities to a compute function and validate
    quantified inputs at call time (xclim:core/units.py:1424-1496).

    Applied over a :func:`declare_relative_units` function, the relative
    declarations are materialized by substituting ``<ref>`` with the
    declared ``(ref units)``. Parameters annotated ``Quantified`` must all
    be declared — a missing declaration raises at decoration time."""

    def dec(func):
        import inspect

        decls = dict(units_by_name)
        rel = getattr(func, "relative_units", None)
        if rel:
            for arg, dim in rel.items():
                if arg in decls:
                    continue
                for ref, refdim in units_by_name.items():
                    dim = dim.replace(f"<{ref}>", f"({refdim})")
                if "<" in dim:
                    raise ValueError(
                        f"Relative declaration {rel[arg]!r} of {arg} refers "
                        "to a parameter absent from this declare_units call")
                decls[arg] = dim
        try:
            sig = inspect.signature(func)
        except (TypeError, ValueError):  # pragma: no cover - builtins
            sig = None
        if sig is not None:
            for pname, p in sig.parameters.items():
                ann = p.annotation
                if ann is inspect.Parameter.empty or pname in decls:
                    continue
                is_quant = isinstance(ann, str) and "Quantified" in ann
                if is_quant:
                    raise ValueError(
                        f"Parameter {pname} is Quantified but has no unit "
                        "declaration (xclim declare_units contract)")

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs) if sig is not None else None
            if bound is None:
                return func(*args, **kwargs)
            bound.apply_defaults()
            for name, dim in decls.items():
                if name in bound.arguments and bound.arguments[name] is not None:
                    val = bound.arguments[name]
                    if isinstance(val, (str, Quantity)) or hasattr(val, "attrs"):
                        check_units(val, dim)
            return func(*args, **kwargs)

        wrapper.in_units = decls
        wrapper.__wrapped__ = func
        return wrapper

    return dec


def declare_relative_units(**units_by_name):
    """Declare input dimensionality relative to other inputs
    (xclim:core/units.py:1313). e.g. thresh='<da>' means same dims as `da`."""

    def dec(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            import inspect

            bound = inspect.signature(func).bind(*args, **kwargs)
            bound.apply_defaults()
            for name, rel in units_by_name.items():
                val = bound.arguments.get(name)
                if val is None:
                    continue
                m = re.match(r"^<(\w+)>$", rel.strip())
                if not m:
                    continue
                ref = bound.arguments.get(m.group(1))
                if ref is None:
                    continue
                try:
                    ru = units2pint(ref)
                    vu = units2pint(val)
                except UnitError:
                    continue
                if vu.dims != ru.dims and not _hydro_compatible(vu, ru):
                    raise UnitError(
                        f"{name} units {vu.to_cf()!r} incompatible with {m.group(1)} "
                        f"units {ru.to_cf()!r}")
            return func(*args, **kwargs)

        wrapper.relative_units = units_by_name
        wrapper.__wrapped__ = func
        return wrapper

    return dec


def ensure_cf_units(ustr: str) -> str:
    return parse_units(ustr).to_cf()


def ensure_delta(ustr: str) -> str:
    """Temperature unit → its delta form (xclim ensure_delta)."""
    u = parse_units(ustr)
    if u.dims == _dv(K=1) and u.offset != 0:
        return "delta_" + u.to_cf()
    return u.to_cf()


# ---------------------------------------------------------------------------
# Aggregation units & rate/amount conversions
# ---------------------------------------------------------------------------

_FREQ_UNIT = {"s": "s", "min": "min", "h": "h", "D": "d", "W": "week", "M": "month",
              "Y": "yr"}


def infer_sampling_units(da, deffreq: str | None = None) -> tuple[int, str]:
    """(multiplier, unit string) of the sampling frequency
    (xclim:core/units.py:503-553): quarters count as 3 months, a 7-day
    step reports as one week, and an uninferable frequency with no
    ``deffreq`` raises."""
    time = getattr(da, "time", None)
    freq = time.infer_freq() if time is not None and len(time) > 2 else None
    if freq is None:
        freq = deffreq
    if freq is None:
        raise ValueError("Unable to find the sampling frequency of the data.")
    from xclim_tpu_torch.core.calendar import parse_offset

    mult, base, _, _ = parse_offset(freq)
    if base == "Q":
        mult, base = mult * 3, "M"
    if base not in _FREQ_UNIT:
        raise ValueError(f"Sampling frequency {freq} has no corresponding "
                         "CF units.")
    u = _FREQ_UNIT[base]
    if u == "d" and mult == 7:
        mult, u = 1, "week"
    return mult, u


def _reduce_time_symbols(u: Units) -> tuple[Units, float]:
    """Cancel pure-time symbols against each other (d × h-1 → 24).

    Returns the reduced unit and the factor the DATA must be multiplied by
    to stay numerically equal. A nonzero net time exponent keeps one symbol
    (the sampling unit's, i.e. the last positive one)."""
    tdim = _dv(T=1)
    tsyms = [(s, e) for s, e in u.symbols if parse_units(s).dims == tdim]
    if len(tsyms) < 2:
        return u, 1.0
    net = sum(e for _, e in tsyms)
    factor = 1.0
    for s, e in tsyms:
        factor *= parse_units(s).scale ** float(e)
    keep = ()
    if net != 0:
        pick = next((s for s, e in reversed(tsyms) if (e > 0) == (net > 0)),
                    tsyms[-1][0])
        keep = ((pick, net),)
        factor /= parse_units(pick).scale ** float(net)
    others = tuple((s, e) for s, e in u.symbols
                   if parse_units(s).dims != tdim)
    syms = tuple(sorted(others + keep))
    return Units(u.scale, u.offset, u.dims, syms, delta=u.delta), factor


def to_agg_units(out, orig, op: str, deffreq: str | None = None):
    """Set units after a time aggregation (xclim:core/units.py:621).

    count → sampling unit ('d'); integral → units × time; doymin/doymax → ''
    with is_dayofyear attr; var → units²; others inherit.
    """
    ou = units2pint(orig)
    if op in ("min", "max", "amin", "amax", "mean", "sum"):
        out.attrs["units"] = orig.attrs.get("units", "")
    elif op == "std":
        out.attrs["units"] = orig.attrs.get("units", "")
        out.attrs["units_metadata"] = "temperature: difference" if ou.is_temperature else \
            out.attrs.get("units_metadata", "")
        if not out.attrs.get("units_metadata"):
            out.attrs.pop("units_metadata", None)
    elif op == "var":
        out.attrs["units"] = pint2cfunits(ou ** 2)
    elif op in ("doymin", "doymax"):
        from xclim_tpu_torch.core.calendar import get_calendar

        out.attrs.update(units="1", is_dayofyear=np.int32(1))
        try:
            out.attrs["calendar"] = get_calendar(orig)
        except ValueError:
            pass
    elif op in ("count", "integral"):
        m, funit = infer_sampling_units(orig, deffreq=deffreq)
        if m != 1:
            out.data = out.data * m
        if op == "count":
            out.attrs["units"] = funit
        else:
            if ou.is_temperature:
                ou = Units(ou.scale, 0.0, ou.dims, ou.symbols, delta=True)
            prod = ou * parse_units(funit)
            if prod.dims == _dv():  # time × rate cancels
                out.attrs["units"] = "1" if prod.scale == 1.0 else prod.to_cf()
                if prod.scale != 1.0:
                    out.data = out.data * prod.scale
                    out.attrs["units"] = "1"
            else:
                # the reference reduces mixed time symbols after the
                # multiplication (pint to_reduced_units,
                # xclim:core/units.py:721-728): m/h summed daily is 'm'
                # with the data scaled by 24, not 'd m h-1'
                prod, factor = _reduce_time_symbols(prod)
                if factor != 1.0:
                    out.data = out.data * factor
                out.attrs.update(pint2cfattrs(prod, is_difference=ou.delta))
    else:
        raise ValueError(f"Unknown aggregation op {op}")
    if op in ("doymin", "doymax", "count"):
        out.attrs.pop("units_metadata", None)
    return out


def _sampling_seconds(da) -> np.ndarray:
    time = da.time
    return time.timestep_seconds()


def _like(data: torch.Tensor, arr: np.ndarray) -> torch.Tensor:
    """Host float32 array as a tensor on ``data``'s device."""
    return torch.as_tensor(arr.astype(np.float32), device=data.device)


def rate2amount(rate, out_units: str | None = None):
    """Rate → amount by multiplying with each timestep's duration
    (xclim:core/units.py:854). Non-uniform steps (months) are handled exactly.

    The duration is expressed in the rate's own time denominator ('d' for
    mm/d) so the amount unit cancels cleanly (mm/d × 1 d → mm, not the
    unsimplified mm·s/d the naive seconds product would produce)."""
    dt = _sampling_seconds(rate)  # (T,)
    taxis = rate.dims.index("time")
    shape = [1] * rate.data.ndim
    shape[taxis] = len(dt)
    u = units2pint(rate)
    time_sym = None
    for sym, exp in u.symbols:
        if exp < 0:
            try:
                sc, off, dims, _canon = _resolve_symbol(sym)
            except UnitError:
                continue
            if dims == _dv(T=1) and off == 0.0:
                time_sym = (sym, sc)
                break
    if time_sym is not None:
        sym, sc = time_sym
        amount_u = u * parse_units(sym)
        data = rate.data * _like(rate.data, (dt / sc).reshape(shape))
    else:
        amount_u = u * parse_units("s")
        data = rate.data * _like(rate.data, dt.reshape(shape))
    out = rate.copy(data=data)
    out.attrs = dict(rate.attrs)
    out.attrs["units"] = amount_u.to_cf()
    if out.attrs.get("standard_name", "").endswith("_flux"):
        out.attrs["standard_name"] = out.attrs["standard_name"].replace("_flux", "_amount")
    if out_units:
        out = convert_units_to(out, out_units, context="hydro")
    return out


def amount2rate(amount, out_units: str | None = None):
    """Amount → rate (divide by timestep duration; xclim:core/units.py:941)."""
    dt = _sampling_seconds(amount)
    taxis = amount.dims.index("time")
    shape = [1] * amount.data.ndim
    shape[taxis] = len(dt)
    u = units2pint(amount)
    rate_u = u / parse_units("s")
    data = amount.data / _like(amount.data, dt.reshape(shape))
    out = amount.copy(data=data)
    out.attrs = dict(amount.attrs)
    out.attrs["units"] = rate_u.to_cf()
    if out_units:
        out = convert_units_to(out, out_units, context="hydro")
    return out


def amount2lwethickness(amount, out_units: str | None = None):
    """kg m-2 → mm liquid-water-equivalent thickness (xclim:core/units.py:995)."""
    out = convert_units_to(amount, "mm", context="hydro")
    sn = out.attrs.get("standard_name")
    if sn and not sn.startswith("lwe_"):
        out.attrs["standard_name"] = "lwe_thickness_of_" + sn
    if out_units:
        out = convert_units_to(out, out_units)
    return out


def lwethickness2amount(thickness, out_units: str | None = None):
    out = convert_units_to(thickness, "kg m-2", context="hydro")
    sn = out.attrs.get("standard_name")
    if sn and sn.startswith("lwe_thickness_of_"):
        out.attrs["standard_name"] = sn[len("lwe_thickness_of_"):]
    if out_units:
        out = convert_units_to(out, out_units)
    return out


def rate2flux(rate, density, out_units: str | None = None):
    """Rate (m/s-like) → mass flux using a density Quantity
    (xclim:core/units.py:1109)."""
    rho = str2pint(density) if isinstance(density, str) else density
    u = units2pint(rate) * rho.units
    out = rate.copy(data=rate.data * rho.magnitude)
    out.attrs = dict(rate.attrs)
    out.attrs["units"] = u.to_cf()
    if out_units:
        out = convert_units_to(out, out_units)
    return out


def flux2rate(flux, density, out_units: str | None = None):
    rho = str2pint(density) if isinstance(density, str) else density
    u = units2pint(flux) / rho.units
    out = flux.copy(data=flux.data / rho.magnitude)
    out.attrs = dict(flux.attrs)
    out.attrs["units"] = u.to_cf()
    if out_units:
        out = convert_units_to(out, out_units)
    return out


# CF standard-name transformations per conversion family (the reference loads
# these from data/variables.yml `conversions:`; xclim core/units.py:454)
CF_CONVERSIONS = {
    "amount2rate": {
        "prefix": {"to": "", "from": ""},
        "rules": [
            ("lwe_thickness_of_", "lwe_", "rate"),
            ("thickness_of_", "", "rate"),
            ("_amount", "_flux", None),
        ],
    },
    "amount2lwethickness": {},
}


def cf_conversion(standard_name: str, conversion: str, direction: str):
    """Standard name after applying a CF conversion, or None when the CF
    vocabulary defines no counterpart (xclim core/units.py:454)."""
    pairs = {
        "amount2rate": [("precipitation_amount", "precipitation_flux"),
                        ("lwe_thickness_of_precipitation_amount",
                         "lwe_precipitation_rate"),
                        ("snowfall_amount", "snowfall_flux"),
                        ("surface_runoff_amount", "surface_runoff_flux")],
        "amount2lwethickness": [("precipitation_amount",
                                 "lwe_thickness_of_precipitation_amount"),
                                ("snowfall_amount",
                                 "lwe_thickness_of_snowfall_amount")],
    }.get(conversion, [])
    for frm, to in pairs:
        if direction == "to" and standard_name == frm:
            return to
        if direction == "from" and standard_name == to:
            return frm
    return None


def ensure_absolute_temperature(units):
    """Convert delta/relative temperature units to their absolute counterpart
    ('delta_degC'/'degC' → 'K'; xclim core/units.py)."""
    u = str(units)
    if "delta_" in u:
        u = u.replace("delta_", "")
    p = parse_units(u)
    if p.dims == _dv(K=1) and p.offset != 0.0:
        return "K"
    return u


#: SI base symbol per dimension slot of ``_DIMS``
_BASE_SYMBOL = {"L": "m", "M": "kg", "T": "s", "K": "K", "A": "rad",
                "N": "mol"}


def pint_multiply(da, q, out_units: str | None = None):
    """Multiply a ClimArray by a quantified scalar, tracking units.

    Matches the reference (xclim:core/units.py:231-263): the quantity is
    first expressed in SI base units, so its symbols cancel against the
    array's — ``kg m-2 s-1`` times ``1 d`` scales the data by 86400 and
    prints ``kg m-2``, not ``d kg m-2 s-1``."""
    qty = str2pint(q) if isinstance(q, str) else q
    mag = qty.magnitude if hasattr(qty, "magnitude") else float(qty)
    u_q = qty.units if hasattr(qty, "units") else DIMENSIONLESS
    u_in = parse_units(da.attrs.get("units", ""))
    base_syms = tuple((_BASE_SYMBOL[d], e)
                      for d, e in zip(_DIMS, u_q.dims) if e != 0)
    u_base = Units(1.0, 0.0, u_q.dims, base_syms)
    out = da.copy(data=da.data * (mag * u_q.scale))
    out.attrs = dict(da.attrs)
    out.attrs["units"] = pint2cfunits(u_in * u_base)
    if out_units is not None:
        out = convert_units_to(out, out_units)
    return out
