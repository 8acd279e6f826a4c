"""``BENCHMARK.json``: loading, the checks of its names and units, and the
lookups the harness makes by a cell's name.

Every file the harness reads for a cell is found by a name in it: the
configuration ``perfbench/configs/<config>.json`` (its ``file``), the
traffic mix ``perfbench/traffic/<traffic>.json``, and each metric's reader
``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(path: Path | None = None) -> dict:
    """The parsed ``BENCHMARK.json`` (at the repo's root by default); raises
    ValueError listing every fault :func:`problems` finds."""
    path = path or ROOT / "BENCHMARK.json"
    if path.stat().st_size > 64 * 1024:
        raise ValueError(f"{path} is over 64 KiB")
    bench = json.loads(path.read_text())
    faults = problems(bench)
    if faults:
        raise ValueError(f"{path}:\n" + "\n".join(faults))
    return bench


def _line(text, limit=200) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def problems(bench: dict) -> list[str]:
    """The contract's faults of a parsed benchmark: keys, names, units,
    bounds and cross references. Empty when it is sound."""
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)} != {sorted(TOP_KEYS)}")
        return out
    cmd, paths = bench["command"], bench["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(_line(w) for w in cmd)):
        out.append("command: 1 to 32 one-line words")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16
            and all(isinstance(p, str) and PATH.fullmatch(p)
                    and not p.startswith("/") and ".." not in p.split("/")
                    for p in paths)):
        out.append("paths: 1 to 16 relative paths")
    rs = bench["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds: a whole number from 1 to 51")
    names = set()

    def named(entry, keys, what, extra=()):
        if not isinstance(entry, dict):
            out.append(f"{what} {entry!r} is not an object")
            return False
        if not keys <= set(entry) or set(entry) - keys - set(extra):
            out.append(f"{what} {entry.get('name')}: keys {sorted(entry)} "
                       f"!= {sorted(keys)}")
            return False
        name = entry["name"]
        if not (isinstance(name, str) and NAME.fullmatch(name)):
            out.append(f"{what} name {name!r} is not a name")
        if name in names:
            out.append(f"{what} name {name!r} is used twice")
        names.add(name)
        return True

    configs = {}
    if not 1 <= len(bench["configs"]) <= 24:
        out.append("configs: 1 to 24")
    for c in bench["configs"]:
        if not named(c, CONFIG_KEYS, "config"):
            continue
        configs[c["name"]] = c
        if not _line(c["source"]) or not _line(c["why"]):
            out.append(f"config {c['name']}: source and why are one line "
                       f"of 1 to 200 characters")
        if not (isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
                and all(isinstance(k, str) and NAME.fullmatch(k)
                        for k in c["reduced"])):
            out.append(f"config {c['name']}: reduced is up to 16 names")
        if not (isinstance(c["file"], str) and PATH.fullmatch(c["file"])
                and any(c["file"].startswith(p.rstrip("/") + "/")
                        for p in paths)):
            out.append(f"config {c['name']}: file {c['file']!r} is not "
                       f"under paths")
    if len({c["file"] for c in configs.values()}) != len(configs):
        out.append("two configurations share a file")

    cells = {}
    if not 1 <= len(bench["workloads"]) <= 24:
        out.append("workloads: 1 to 24")
    pairs = set()
    for w in bench["workloads"]:
        if not named(w, CELL_KEYS, "workload"):
            continue
        cells[w["name"]] = w
        if w["config"] not in configs:
            out.append(f"workload {w['name']}: no config {w['config']!r}")
        if not (isinstance(w["traffic"], str)
                and NAME.fullmatch(w["traffic"])):
            out.append(f"workload {w['name']}: traffic is not a name")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips is 1 or 4")
        if not _line(w["why"]):
            out.append(f"workload {w['name']}: why is one line of 1 to 200 "
                       f"characters")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            out.append(f"workload {w['name']}: config and traffic repeat")
        pairs.add(pair)
    if sum(w["chips"] == 4 for w in cells.values()) > max(1, len(cells) // 4):
        out.append("too many four-chip cells")
    used = {w["config"] for w in cells.values()}
    for name in configs:
        if name not in used:
            out.append(f"config {name} is used by no cell")

    def metric(m, keys, what):
        if not named(m, keys, what, extra=("workloads",)):
            return False
        if not (isinstance(m["unit"], str) and UNIT.fullmatch(m["unit"])):
            out.append(f"{what} {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{what} {m['name']}: better is lower or higher")
        if m["source"] not in SOURCES:
            out.append(f"{what} {m['name']}: source {m['source']!r}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"{what} {m['name']}: no workload {cell!r}")
        return True

    e2e = {}
    if not 1 <= len(bench["end_to_end"]) <= 16:
        out.append("end_to_end: 1 to 16")
    for m in bench["end_to_end"]:
        if not metric(m, E2E_KEYS, "end_to_end"):
            continue
        e2e[m["name"]] = m
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"end_to_end {m['name']}: source is host_clock or "
                       f"device_trace")
        b = m["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            out.append(f"end_to_end {m['name']}: bound {b} outside "
                       f"[0.01, 0.25]")
    if "setup_s" not in e2e:
        out.append("end_to_end: setup_s is missing")
    if not 1 <= len(bench["per_layer"]) <= 128:
        out.append("per_layer: 1 to 128")
    for m in bench["per_layer"]:
        if not metric(m, LAYER_KEYS, "per_layer"):
            continue
        if not _line(m["layer"]):
            out.append(f"per_layer {m['name']}: layer is one line")
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"per_layer {m['name']}: moves {m['moves']!r}, no "
                       f"end-to-end metric")
            continue
        for cell in m.get("workloads", list(cells)):
            if cell in cells and cell not in moved.get("workloads", cells):
                out.append(f"per_layer {m['name']}: cell {cell} does not "
                           f"report {m['moves']}")
    for name in cells:
        mine = [m for m in bench["end_to_end"]
                if name in m.get("workloads", cells)]
        if len(mine) < 2:
            out.append(f"workload {name}: needs setup_s and one more "
                       f"end-to-end metric")
        if not any(name in m.get("workloads", cells)
                   for m in bench["per_layer"]):
            out.append(f"workload {name}: no per-layer metric")
    return out


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell_entry: dict) -> dict:
    """The configuration file of a cell, parsed."""
    entry = next(c for c in bench["configs"]
                 if c["name"] == cell_entry["config"])
    return json.loads((ROOT / entry["file"]).read_text())


def traffic_of(cell_entry: dict) -> dict:
    """The cell's traffic mix: ``perfbench/traffic/<traffic>.json``."""
    return json.loads((PKG / "traffic" / f"{cell_entry['traffic']}.json")
                      .read_text())


def metrics_of(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    that list it, and those without a list (a per-layer metric without
    one goes where the end-to-end metric it moves goes)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench[kind]:
        cells = m.get("workloads")
        if cells is None and kind == "per_layer":
            cells = e2e[m["moves"]].get("workloads")
        if cells is None or cell_name in cells:
            out.append(m)
    return out
