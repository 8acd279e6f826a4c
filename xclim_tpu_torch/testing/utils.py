"""Testing support utilities (reference: xclim:src/xclim/testing/utils.py).

The reference fetches test NetCDFs from the Ouranosinc/xclim-testdata
repository with pooch (``nimbus``, utils.py:469). This package generates
its test data synthetically (:mod:`xclim_tpu_torch.testing.helpers`) and runs in
network-isolated environments, so the fetcher API is preserved as local-only:
``nimbus().fetch(name)`` resolves files under the local cache directory and
raises a clear error when a file is absent instead of downloading.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = [
    "TESTDATA_BRANCH",
    "TESTDATA_CACHE_DIR",
    "TESTDATA_REPO_URL",
    "audit_url",
    "default_testdata_cache",
    "default_testdata_repo_url",
    "default_testdata_version",
    "gather_testing_data",
    "list_input_variables",
    "nimbus",
    "open_dataset",
    "populate_testing_data",
    "publish_release_notes",
    "run_doctests",
    "show_versions",
    "testing_setup_warnings",
]

default_testdata_version = "local"
default_testdata_repo_url = "https://github.com/Ouranosinc/xclim-testdata"
default_testdata_cache = Path(
    os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")) / "xclim_tpu_torch-testdata"

TESTDATA_BRANCH = os.environ.get("XCLIM_TESTDATA_BRANCH", "main")
TESTDATA_REPO_URL = os.environ.get("XCLIM_TESTDATA_REPO_URL",
                                   default_testdata_repo_url)
TESTDATA_CACHE_DIR = Path(os.environ.get("XCLIM_TESTDATA_CACHE_DIR",
                                         default_testdata_cache))


def audit_url(url: str, context: str | None = None) -> str:
    """Validate that a URL is well-formed and uses https
    (xclim:testing/utils.py)."""
    from urllib.parse import urlparse

    parsed = urlparse(url)
    if parsed.scheme != "https":
        msg = f"URLs must use HTTPS: {url}"
        if context:
            msg = f"{context}: {msg}"
        raise ValueError(msg)
    return url


class _LocalNimbus:
    """Local-only stand-in for the pooch fetcher (xclim:testing/utils.py:469)."""

    def __init__(self, repo: str, branch: str, cache_dir: Path):
        self.repo = repo
        self.branch = branch
        self.path = Path(cache_dir)

    def fetch(self, name: str) -> str:
        local = self.path / name
        if local.exists():
            return str(local)
        raise FileNotFoundError(
            f"Test file {name!r} not found under {self.path}. This package runs "
            "without network access: place files there manually or generate "
            "synthetic data with xclim_tpu_torch.testing.helpers.")


def nimbus(repo: str = TESTDATA_REPO_URL, branch: str = TESTDATA_BRANCH,
           cache_dir=TESTDATA_CACHE_DIR):
    """Local-only testing-data fetcher (xclim:testing/utils.py:469)."""
    return _LocalNimbus(repo, branch, Path(cache_dir))


def open_dataset(name, cache_dir=TESTDATA_CACHE_DIR, **kwargs):
    """Open a testing NetCDF by name from the local cache
    (xclim:testing/utils.py:571); ``device`` among the keywords as for
    :func:`xclim_tpu_torch.io.open_dataset`."""
    from xclim_tpu_torch.io import open_dataset as _open

    path = Path(name)
    if not path.exists():
        path = nimbus(cache_dir=cache_dir).fetch(str(name))
    return _open(path, **kwargs)


def gather_testing_data(worker_cache_dir, worker_id: str = "master"):
    """No-op here: data is synthetic (xclim:testing/utils.py:656)."""
    return None


def populate_testing_data(temp_folder=None, repo: str = TESTDATA_REPO_URL,
                          branch: str = TESTDATA_BRANCH, local_cache=None):
    """No-op here: no network access (xclim:testing/utils.py)."""
    return None


def testing_setup_warnings():
    """Warn when the local testing setup deviates from defaults."""
    import warnings

    if TESTDATA_BRANCH != "main":
        warnings.warn(f"Testing data branch set to {TESTDATA_BRANCH!r}.")


def list_input_variables(submodules=None, realms=None) -> dict:
    """Variable name → list of indicators using it
    (xclim:testing/utils.py:148)."""
    import xclim_tpu_torch.indicators  # noqa: F401  (fills the registry)
    from xclim_tpu_torch.core.indicator import InputKind, registry

    out: dict[str, list] = {}
    for key, ind in registry.items():
        if realms and (ind.realm not in realms):
            continue
        for name, p in ind.parameters.items():
            if p.kind in (InputKind.VARIABLE, InputKind.OPTIONAL_VARIABLE):
                out.setdefault(name, []).append(key.lower())
    return out


def publish_release_notes(style: str = "md", file=None, changes=None) -> str | None:
    """Return (or write) the changelog (xclim:testing/utils.py:203)."""
    root = Path(__file__).parent.parent.parent
    changelog = root / "CHANGELOG.md"
    text = changelog.read_text() if changelog.exists() else ""
    if file is not None:
        if hasattr(file, "write"):
            file.write(text)
        else:
            Path(file).write_text(text)
        return None
    return text


def show_versions(file=None, deps=None) -> str | None:
    """Print versions of the package and its dependencies
    (xclim:testing/utils.py:312)."""
    import numpy
    import torch

    import xclim_tpu_torch

    lines = [f"xclim_tpu_torch: {xclim_tpu_torch.__version__}",
             f"torch: {torch.__version__}",
             f"cuda: {torch.version.cuda}",
             f"numpy: {numpy.__version__}"]
    try:
        import scipy

        lines.append(f"scipy: {scipy.__version__}")
    except ImportError:
        pass
    text = "\n".join(lines)
    if file is not None:
        if hasattr(file, "write"):
            file.write(text)
        else:
            Path(file).write_text(text)
        return None
    return text


def run_doctests():
    """Run the test suite's doctest collection (compatibility wrapper)."""
    import subprocess
    import sys

    return subprocess.call([sys.executable, "-m", "pytest", "--doctest-modules",
                            "xclim_tpu_torch/core/calendar.py"])
