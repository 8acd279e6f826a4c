"""The PyTorch port stands alone: it imports without JAX, no source file of
it imports JAX or Triton, its ops import nothing above them and leave
binding and launching kernels to ``ops/_build.py``, and its kernels are
CUDA sources built for sm_90a. The benchmark's plain references import
neither JAX nor either package."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

from xclim_tpu_torch.ops import _build

PKG = pathlib.Path(__file__).resolve().parent.parent / "xclim_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))
REFERENCES = sorted((PKG.parent / "perfbench" / "reference").glob("*.py"))
OPS = sorted((PKG / "ops").glob("*.py"))
#: the layers above ops: an op module imports none of them
ABOVE_OPS = ("core.dataarray", "sdba", "indices", "indicators", "ensembles")
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(
        ".__init__") for p in SOURCES)


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def _imported_modules(path: pathlib.Path) -> set[str]:
    """Every module an import statement of ``path`` names, at any depth,
    with each ``from m import n`` also as ``m.n``."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                pkg = "xclim_tpu_torch.ops".split(".")[:3 - node.level]
                base = ".".join(pkg + ([base] if base else []))
            found.add(base)
            found.update(f"{base}.{a.name}" for a in node.names)
    return found


def test_import_with_jax_poisoned():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['triton'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'xclim_tpu' or k.startswith('xclim_tpu.')\n"
            "               for k in sys.modules), 'reference package loaded'\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_triton_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "triton", "xclim_tpu"}, roots


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: p.name)
def test_references_import_neither_jax_nor_either_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "xclim_tpu", "xclim_tpu_torch"}, \
        roots


@pytest.mark.parametrize("path", OPS, ids=lambda p: p.name)
def test_ops_import_nothing_above_them(path):
    above = [m for m in _imported_modules(path)
             for layer in ABOVE_OPS
             if m == f"xclim_tpu_torch.{layer}"
             or m.startswith(f"xclim_tpu_torch.{layer}.")]
    assert not above, above


@pytest.mark.parametrize("path", [p for p in OPS if p.name != "_build.py"],
                         ids=lambda p: p.name)
def test_only_the_build_module_binds_and_launches_kernels(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    assert "ctypes" not in _imported_roots(path)
    assert not [n for n in ast.walk(tree)
                if isinstance(n, ast.Attribute) and n.attr == "current_stream"
                or isinstance(n, ast.Name) and n.id == "current_stream"]


@pytest.mark.parametrize("name", sorted({_build.source(t).stem
                                         for t in _build.TARGETS}))
def test_kernels_are_cuda_sources_for_sm90a(name):
    """Each source under csrc/ is a CUDA kernel with a C entry of its name,
    and its note names the reference it replaces: a Pallas kernel of the
    same name, or, with no Pallas kernel, the reference's plain-jnp module
    (the op of the same name, or the sdba, ensembles or core module of the
    function) and the port's twin."""
    src = PKG / "csrc" / f"{name}.cu"
    text = src.read_text()
    assert _build.source(name) == src
    assert "__global__" in text
    assert f'extern "C" int xtt_{name}' in text
    note = text[text.index("// Replaces: "):].split("\n//\n")[0]
    refs = re.findall(r"xclim_tpu/(?:ops|sdba|ensembles|core)/[\w/]+\.py",
                      note)
    assert refs and all((PKG.parent / r).exists() for r in refs), note
    if note.startswith("// Replaces: no Pallas kernel"):
        assert refs[0] == f"xclim_tpu/ops/{name}.py" \
            or refs[0].startswith(("xclim_tpu/sdba/", "xclim_tpu/ensembles/",
                                   "xclim_tpu/core/"))
        assert f"xclim_tpu_torch/ops/{name}.py" in note
        assert re.search(r"\w+_plain\b", note)
    else:
        assert refs[0] == f"xclim_tpu/ops/pallas/{name}.py"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_targets_build_every_source():
    assert {_build.source(t) for t in _build.TARGETS} == set(
        (PKG / "csrc").glob("*.cu"))
    assert set(_build.VARIANTS) <= set(_build.TARGETS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_OUT", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("winquantile")


def test_stage_profile_is_a_separate_build():
    # the shipped winquantile library leaves the profiling stages out; the
    # winquantile_stages target compiles the same source with them
    src = _build.source("winquantile_stages")
    assert src == _build.source("winquantile") == PKG / "csrc" / "winquantile.cu"
    assert _build._so_path("winquantile_stages") != _build._so_path(
        "winquantile")
    assert "-DXTT_WINQUANTILE_STAGES" in _build._flags("winquantile_stages")
    assert "-DXTT_WINQUANTILE_STAGES" not in _build._flags("winquantile")
    text = src.read_text()
    guard = text.index("#ifdef XTT_WINQUANTILE_STAGES")
    assert guard < text.index('extern "C" int xtt_winquantile_stages(')
    assert text.index('extern "C" int xtt_winquantile(') < guard


def test_default_device_is_cpu_here():
    """Host data goes to the card; without one, default_device() raises
    (naming device="cpu") instead of carrying on on the CPU."""
    import torch

    import xclim_tpu_torch

    if torch.cuda.is_available():
        assert xclim_tpu_torch.default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            xclim_tpu_torch.default_device()
