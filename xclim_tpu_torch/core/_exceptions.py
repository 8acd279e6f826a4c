"""Exceptions and severity routing (reference: xclim:src/xclim/core/_exceptions.py)."""

from __future__ import annotations

import logging
import warnings

logger = logging.getLogger("xclim_tpu_torch")

__all__ = ["MissingVariableError", "ValidationError", "raise_warn_or_log"]


class ValidationError(ValueError):
    """Error raised when input data to an indicator fails the health checks."""

    @property
    def msg(self):
        return self.args[0]


class MissingVariableError(ValueError):
    """Error raised when a dataset is passed but the needed variable is absent."""


def raise_warn_or_log(err: Exception, mode: str, msg: str | None = None,
                      err_type: type = ValueError, stacklevel: int = 1):
    """Route an error according to an option mode: raise / warn / log / silent
    (xclim:core/_exceptions.py:25)."""
    message = msg or str(err)
    if mode == "raise":
        if isinstance(err, err_type):
            raise err
        raise err_type(message) from err
    if mode == "warn":
        warnings.warn(message, stacklevel=stacklevel + 1)
    elif mode == "log":
        logger.info(message)
    # silent: pass
