"""BENCHMARK.json against the contract's names, units and references, and
the faults the check finds in broken copies of it."""

import copy
import json

import pytest

from perfbench import spec
from perfbench.run import metric_reader


def test_benchmark_is_sound(bench):
    assert spec.problems(bench) == []
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_every_name_has_its_files(bench):
    for w in bench["workloads"]:
        assert spec.traffic_of(w)["loop"] == "closed"
        cfg = spec.config_of(bench, w)
        for limit in cfg["limits"].values():
            assert limit > 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(m["name"]).read)


BROKEN = [
    ("end_to_end", 0, "name", "cell days/s"),
    ("end_to_end", 0, "unit", "cell-days per s"),
    ("end_to_end", 0, "unit", "µs"),
    ("end_to_end", 0, "better", "up"),
    ("end_to_end", 0, "bound", 0.3),
    ("end_to_end", 0, "source", "program_span"),
    ("per_layer", 0, "moves", "no_such_metric"),
    ("per_layer", 0, "layer", "two\nlines"),
    ("workloads", 0, "chips", 2),
    ("workloads", 0, "config", "no_such_config"),
    ("workloads", 0, "why", "x" * 201),
    ("configs", 0, "file", "elsewhere/x.json"),
]


@pytest.mark.parametrize("kind,i,key,value", BROKEN)
def test_faults_are_found(bench, kind, i, key, value):
    broken = copy.deepcopy(bench)
    broken[kind][i][key] = value
    assert spec.problems(broken)


def test_extra_keys_and_duplicates_are_found(bench):
    broken = copy.deepcopy(bench)
    broken["per_layer"][0]["why"] = "a reason"
    assert spec.problems(broken)
    broken = copy.deepcopy(bench)
    broken["workloads"].append(dict(broken["workloads"][0]))
    assert spec.problems(broken)
    broken = copy.deepcopy(bench)
    broken["extra"] = 1
    assert spec.problems(broken)


def test_setup_s_is_required(bench):
    broken = copy.deepcopy(bench)
    broken["end_to_end"] = [m for m in broken["end_to_end"]
                            if m["name"] != "setup_s"]
    assert any("setup_s" in p for p in spec.problems(broken))


def test_load_refuses_a_broken_file(tmp_path, bench):
    broken = copy.deepcopy(bench)
    broken["run_seconds"] = 60
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(broken))
    with pytest.raises(ValueError, match="run_seconds"):
        spec.load(path)
