"""CF-convention attribute checks (reference: xclim:src/xclim/core/cfchecks.py)."""

from __future__ import annotations

import fnmatch
import re

from xclim_tpu_torch.core._exceptions import ValidationError
from xclim_tpu_torch.core.options import cfcheck
from xclim_tpu_torch.core.variables import VARIABLES

__all__ = ["check_valid", "cfcheck_from_name"]


@cfcheck
def check_valid(var, key: str, expected: str | list[str]):
    """Check that an attribute matches (glob patterns allowed); warn per
    OPTIONS[cf_compliance] (xclim:core/cfchecks.py:22)."""
    attr = var.attrs.get(key)
    if isinstance(expected, str):
        expected = [expected]
    if attr is None or not any(fnmatch.fnmatch(attr, exp) for exp in expected):
        raise ValidationError(
            f"Variable has a non-conforming {key}: Got `{attr}`, expected `{expected}`")
    return None


def cfcheck_from_name(varname: str, vardata, attrs: list[str] | None = None):
    """Check standard_name and cell_methods against the variable vocabulary
    (xclim:core/cfchecks.py:54)."""
    if attrs is None:
        attrs = ["cell_methods", "standard_name"]
    data = VARIABLES.get(varname)
    if data is None:
        return
    if "cell_methods" in data and data["cell_methods"] and "cell_methods" in attrs:
        # verify the expected cell_methods appear within the attribute
        exp = data["cell_methods"]
        got = vardata.attrs.get("cell_methods", "")
        if _cell_methods_mismatch(exp, got):
            check_valid(vardata, "cell_methods", f"*{exp}*")
    if "standard_name" in data and data["standard_name"] and "standard_name" in attrs:
        check_valid(vardata, "standard_name", data["standard_name"])


def _cell_methods_mismatch(expected: str, got: str) -> bool:
    exp = re.sub(r"\s+", " ", expected.strip())
    g = re.sub(r"\s+", " ", (got or "").strip())
    return exp not in g


def _check_cell_methods(data_cell_methods: str | None, expected: str):
    """Raise unless the expected ``name: method`` pair appears within the
    data's cell_methods (xclim:core/cfchecks.py:36-52)."""
    if data_cell_methods is None or _cell_methods_mismatch(
            expected, data_cell_methods):
        raise ValidationError(
            f"Variable has a non-conforming cell_methods: "
            f"Got `{data_cell_methods}`, which do not include the expected "
            f"`{expected}`.")
    return None
