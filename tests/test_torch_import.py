"""The PyTorch port stands alone: it imports without JAX, no source file of
it imports JAX or Triton, and its kernels are CUDA sources built for
sm_90a."""

import ast
import pathlib
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "xclim_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))
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


@pytest.mark.parametrize("name", ["winquantile", "qdmadjust", "segred",
                                  "spells", "axisquantile"])
def test_kernels_are_cuda_sources_for_sm90a(name):
    from xclim_tpu_torch.ops import _build

    src = PKG / "csrc" / f"{name}.cu"
    text = src.read_text()
    assert "__global__" in text
    assert "Replaces: xclim_tpu/ops/pallas/" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_bootstrap_kernel_is_a_cuda_source_that_names_its_twin():
    """The bootstrap's kernel replaces no Pallas kernel: its note names the
    reference's plain-jnp functions and the port's twin instead."""
    from xclim_tpu_torch.ops import _build

    text = (PKG / "csrc" / "bootstrap.cu").read_text()
    assert "__global__" in text
    assert "Replaces: no Pallas kernel" in text
    assert "merge_rank_replaced_year_quantile_plain" in text
    assert 'extern "C" int xtt_bootstrap(' in text
    assert _build.source("bootstrap") == PKG / "csrc" / "bootstrap.cu"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from xclim_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_OUT", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("winquantile")


def test_stage_profile_is_a_separate_build():
    # the shipped winquantile library leaves the profiling stages out; the
    # winquantile_stages target compiles the same source with them
    from xclim_tpu_torch.ops import _build

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
