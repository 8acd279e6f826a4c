"""Global options and the ``set_options`` context manager
(reference: xclim:src/xclim/core/options.py)."""

from __future__ import annotations

from xclim_tpu_torch.core._exceptions import ValidationError, raise_warn_or_log

__all__ = ["OPTIONS", "set_options", "register_missing_method", "MISSING_METHODS",
           "datacheck", "cfcheck"]

METADATA_LOCALES = "metadata_locales"
DATA_VALIDATION = "data_validation"
CF_COMPLIANCE = "cf_compliance"
CHECK_MISSING = "check_missing"
MISSING_OPTIONS = "missing_options"
RUN_LENGTH_UFUNC = "run_length_ufunc"  # kept for API parity; the port ignores it
AS_DATASET = "as_dataset"
RESAMPLE_MAP_BLOCKS = "resample_map_blocks"  # kept for API parity

OPTIONS: dict = {
    METADATA_LOCALES: [],
    DATA_VALIDATION: "raise",
    CF_COMPLIANCE: "warn",
    CHECK_MISSING: "any",
    MISSING_OPTIONS: {},
    RUN_LENGTH_UFUNC: "auto",
    AS_DATASET: False,
    RESAMPLE_MAP_BLOCKS: False,
}

MISSING_METHODS: dict[str, type] = {}

_SEVERITIES = ("raise", "warn", "log", "silent")


def _valid_missing_options(value) -> bool:
    """Per-method validation of a ``missing_options`` dict: the method must
    be registered, the given parameters must exist on its ``__init__``
    signature (unless it accepts **kwargs), and its ``validate`` must accept
    them (xclim:core/options.py:101-127)."""
    import inspect

    if not isinstance(value, dict):
        return False
    for meth, opts in value.items():
        cls = MISSING_METHODS.get(meth)
        if cls is None or not isinstance(opts, dict):
            return False
        sig = inspect.signature(cls.__init__)
        params = {p.name for p in sig.parameters.values()
                  if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                  and p.name != "self"}
        has_var_kw = any(p.kind == p.VAR_KEYWORD
                         for p in sig.parameters.values())
        if not has_var_kw and not set(opts) <= params:
            return False
        try:
            if not cls.validate(**opts):
                return False
        except TypeError:
            return False
    return True


def _valid(name, value):
    if name in (DATA_VALIDATION, CF_COMPLIANCE):
        return value in _SEVERITIES
    if name == CHECK_MISSING:
        return value in MISSING_METHODS or value == "skip"
    if name == METADATA_LOCALES:
        from xclim_tpu_torch.core.locales import _valid_locales

        return isinstance(value, (list, tuple)) and _valid_locales(value)
    if name in (AS_DATASET, RESAMPLE_MAP_BLOCKS):
        return isinstance(value, bool)
    if name == MISSING_OPTIONS:
        return _valid_missing_options(value)
    if name == RUN_LENGTH_UFUNC:
        return value in ("auto", True, False)
    return False


def register_missing_method(name: str):
    """Class decorator registering a missing-value method
    (xclim:core/options.py:88)."""

    def dec(cls):
        MISSING_METHODS[name] = cls
        cls.name = name
        return cls

    return dec


class set_options:
    """Set xclim_tpu_torch options globally or inside a ``with`` block
    (xclim:core/options.py:244)."""

    def __init__(self, **kwargs):
        self.old = {}
        for k, v in kwargs.items():
            if k not in OPTIONS:
                raise ValueError(f"Unknown option {k!r}; valid are {sorted(OPTIONS)}")
            if not _valid(k, v):
                raise ValueError(f"Invalid value {v!r} for option {k!r}")
            self.old[k] = OPTIONS[k]
            if k == MISSING_OPTIONS:
                merged = dict(OPTIONS[k])
                merged.update(v)
                OPTIONS[k] = merged
            else:
                OPTIONS[k] = v

    def __enter__(self):
        return self

    def __exit__(self, *args):
        OPTIONS.update(self.old)


def datacheck(func):
    """Decorator routing data-validation failures per OPTIONS[data_validation]
    (xclim:core/options.py:144)."""
    import functools

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except ValidationError as err:
            raise_warn_or_log(err, OPTIONS[DATA_VALIDATION], err_type=ValidationError)
        return None

    return wrapper


def cfcheck(func):
    """Decorator routing CF-compliance failures per OPTIONS[cf_compliance]
    (xclim:core/options.py:166)."""
    import functools

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except ValidationError as err:
            raise_warn_or_log(err, OPTIONS[CF_COMPLIANCE], err_type=ValidationError)
        return None

    return wrapper


def run_check(func, option, *args, **kwargs):
    """Run a check function, handling the raise/warn/log behavior configured
    for `option` (xclim:core/options.py run_check)."""
    from xclim_tpu_torch.core._exceptions import ValidationError, raise_warn_or_log

    try:
        func(*args, **kwargs)
    except ValidationError as err:
        raise_warn_or_log(err, OPTIONS[option], err_type=ValidationError)
