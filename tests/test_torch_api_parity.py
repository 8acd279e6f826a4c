"""The port's public names against the name lists of
``tests/test_api_parity.py``, which this file reads (with ``ast``) and
never edits: every reference indicator identifier is registered, every
listed module export resolves in the port's module of the same name
(``xclim_tpu.<m>`` -> ``xclim_tpu_torch.<m>``), the YAML modules hold
their indicators, and the registry holds the JAX package's 349 entries.
Beyond those lists: the names ``xclim_tpu/__init__.py`` exports, and every
indicator a realm module of the JAX package exposes."""

import ast
import importlib
import pathlib

import pytest

import xclim_tpu_torch
from xclim_tpu_torch.core.indicator import Indicator, registry

PARITY = pathlib.Path(__file__).resolve().parent / "test_api_parity.py"


def _parity_lists():
    """(REF_INDICATOR_IDS, [(module, names), ...]) as test_api_parity.py
    states them."""
    tree = ast.parse(PARITY.read_text())
    ids, exports = None, None
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "REF_INDICATOR_IDS"
                for t in node.targets):
            ids = node.value.func.value.value.split()
        if isinstance(node, ast.FunctionDef) and node.name == "test_module_exports":
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and dec.args and isinstance(
                        dec.args[0], ast.Constant) and dec.args[0].value == "module,names":
                    exports = ast.literal_eval(dec.args[1])
    assert ids and exports, "test_api_parity.py changed its layout"
    return ids, exports


REF_IDS, EXPORTS = _parity_lists()


def _port(module: str) -> str:
    assert module.split(".")[0] == "xclim_tpu"
    return "xclim_tpu_torch" + module[len("xclim_tpu"):]


def _indicators():
    import xclim_tpu_torch.indicators  # noqa: F401  (fills the registry)


def test_parity_lists_read():
    assert len(REF_IDS) == 216 and len(EXPORTS) == 10


def test_all_reference_indicator_identifiers_registered():
    _indicators()
    mine = {k.lower() for k in registry}
    missing = sorted(r for r in set(REF_IDS) if r.lower() not in mine)
    assert missing == [], f"missing indicator identifiers: {missing}"


@pytest.mark.parametrize("module,names", EXPORTS, ids=[m for m, _ in EXPORTS])
def test_module_exports(module, names):
    mod = importlib.import_module(_port(module))
    missing = [n for n in names if not hasattr(mod, n)]
    assert missing == [], f"{_port(module)} missing: {missing}"


def test_yaml_module_counts():
    import xclim_tpu_torch.indicators.anuclim as anuclim
    import xclim_tpu_torch.indicators.cf as cf
    import xclim_tpu_torch.indicators.icclim as icclim

    def count(mod):
        return sum(1 for n in dir(mod)
                   if isinstance(getattr(mod, n, None), Indicator))

    assert (count(icclim), count(anuclim), count(cf)) == (55, 19, 57)


def test_registry_size():
    _indicators()
    builtin = [k for k, v in registry.items()
               if v.module is None or v.module in ("icclim", "anuclim", "cf")]
    assert len(builtin) == 349


#: the names xclim_tpu/__init__.py exports
TOP_LEVEL = ["set_options", "climjit", "climjit_chain", "units", "indices",
             "indicators", "atmos", "generic", "land", "seaIce",
             "build_indicator_module_from_yaml"]


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_exports(name):
    import xclim_tpu

    assert hasattr(xclim_tpu, name)
    assert getattr(xclim_tpu_torch, name) is not None


def test_top_level_import_stays_light():
    """``import xclim_tpu_torch`` loads torch and the eager jit wrappers
    only; the rest loads on first use of a name."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import xclim_tpu_torch\n"
            "mods = sorted(k for k in sys.modules if k.startswith('xclim_tpu_torch'))\n"
            "assert mods == ['xclim_tpu_torch', 'xclim_tpu_torch.core', "
            "'xclim_tpu_torch.core.jit_wrapper'], mods\n"
            "assert xclim_tpu_torch.atmos.tg_mean.identifier == 'tg_mean'\n"
            "assert 'xclim_tpu_torch.indicators.icclim' in sys.modules\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PARITY.parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("realm", ["atmos", "land", "seaIce", "generic", "convert"])
def test_realm_module_names(realm):
    """Every indicator a realm module of the JAX package exposes (aliases
    included) resolves in the port's, to an indicator of the same
    registry key."""
    from xclim_tpu.core.indicator import Indicator as JIndicator

    jmod = importlib.import_module(f"xclim_tpu.indicators.{realm}")
    pmod = importlib.import_module(f"xclim_tpu_torch.indicators.{realm}")
    names = [n for n in dir(jmod) if isinstance(getattr(jmod, n), JIndicator)]
    assert names
    for n in names:
        assert isinstance(getattr(pmod, n, None), Indicator), n
        assert getattr(pmod, n)._registry_key == getattr(jmod, n)._registry_key
