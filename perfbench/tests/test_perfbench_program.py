"""The reading of the program's spans (``perfbench/program.py``) on made-up
events, its five readers, and a traced run of each tiny cell on the CPU."""

import json
import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import program, run, trace
from perfbench.tests.conftest import CELLS, SEED, tiny_config

CUDA = DeviceType.CUDA


class Ev:
    def __init__(self, name, start, end, device=DeviceType.CPU, corr=0,
                 linked=0, kind=None):
        self._n, self._s, self._e, self._d = name, start, end, device
        self._c, self._l = corr, linked
        annotation = "gpu_user_annotation" if device == CUDA \
            else "user_annotation"
        self._k = kind or (annotation if name == "call" or "." in name
                           or name.startswith("xtt:") else "cpu_op")

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def activity_type(self):
        return self._k

    def is_user_annotation(self):
        return self._k in ("user_annotation", "gpu_user_annotation")


def rt(name, start, end, corr):
    return Ev(name, start, end, corr=corr, kind="cuda_runtime")


#: one call: the benchmark's stage, the program's indicator with its
#: compute and the bootstrap's two halves, four launches, two syncs
BASE = [Ev("call", 0, 100), Ev("atmos.indices", 0, 90),
        rt("cudaLaunchKernel", 14, 15, 1), rt("cudaLaunchKernel", 32, 33, 2),
        rt("cudaLaunchKernel", 60, 61, 3), rt("cudaLaunchKernel", 95, 96, 4),
        rt("cudaStreamSynchronize", 40, 45, 5),
        rt("cudaStreamSynchronize", 92, 94, 6),
        Ev("k1", 20, 35, CUDA, corr=1), Ev("k2", 36, 56, CUDA, corr=2),
        # reached through its linked id only
        Ev("k3", 65, 70, CUDA, corr=0, linked=3),
        Ev("Memcpy DtoH", 96, 99, CUDA, corr=4),
        Ev("call", 20, 99, CUDA), Ev("atmos.indices", 20, 70, CUDA)]
PROGRAM = [Ev("xtt:indicator.call", 5, 80),
           Ev("xtt:indicator.compute", 10, 50),
           Ev("xtt:bootstrap.thresholds", 12, 30),
           Ev("xtt:bootstrap.recount", 30, 48),
           # the device-side ranges of the program's spans
           Ev("xtt:indicator.call", 20, 70, CUDA),
           Ev("xtt:bootstrap.recount", 36, 56, CUDA)]
TRACE = SimpleNamespace(spans=[{"name": "bootstrap.recount", "host_syncs": 1},
                               {"name": "indicator.call", "host_syncs": 0}],
                        counters={"host_syncs": 2})


def reading():
    return program.read_events(BASE + PROGRAM, {"atmos.indices"}, 1, TRACE)


def test_annotation_ranges_are_no_device_operations():
    p = reading()
    first = trace.read_profile(BASE, {"atmos.indices"}, 1)
    # busy [20, 35] + [36, 56] + [65, 70] + [96, 99] = 43 ns, with or without
    # the program's ranges, as the benchmark's own reader has it
    assert p["busy_s"] == pytest.approx(43e-9) == first["busy_s"]
    assert p["kernels"] == 3 == first["kernels"]
    assert p["window_s"] == pytest.approx(first["window_s"])
    assert p["span_counts"] == {"indicator.call": 1, "indicator.compute": 1,
                                "bootstrap.thresholds": 1,
                                "bootstrap.recount": 1}
    json.dumps(p)


def test_operations_go_to_the_spans_open_at_their_launch():
    p = reading()
    assert p["program_ms"] == pytest.approx({
        "bootstrap.thresholds": 15e-6, "bootstrap.recount": 20e-6,
        "indicator.compute": 35e-6, "indicator.call": 40e-6})
    # the copy launched at 95 is outside the stage (it ends at 90)
    assert p["stage_ms"] == pytest.approx({"atmos.indices": 40e-6})
    assert p["unattributed_ms"] == 0.0


def test_an_operation_without_its_runtime_call_is_unattributed():
    events = [e for e in BASE + PROGRAM if e.name() != "cudaLaunchKernel"
              or e.correlation_id() != 2]
    p = program.read_events(events, {"atmos.indices"}, 1, TRACE)
    assert p["unattributed_ms"] == pytest.approx(20e-6)
    assert "bootstrap.recount" not in p["program_ms"]
    assert p["program_ms"]["indicator.call"] == pytest.approx(20e-6)


def test_gaps_are_labelled_by_stage_program_span_and_host_op():
    p = reading()
    gaps = dict(p["idle_gaps"])
    assert gaps == {
        "atmos.indices / python": pytest.approx(20e-9),
        "atmos.indices / bootstrap.recount / python": pytest.approx(1e-9),
        "atmos.indices / indicator.call / python": pytest.approx(35e-9),
        "between calls / python": pytest.approx(1e-9)}
    assert sum(gaps.values()) == pytest.approx(p["window_s"] - p["busy_s"])
    assert p["program_idle_ms"] == pytest.approx({
        "indicator.call": 36e-6, "indicator.compute": 1e-6,
        "bootstrap.recount": 1e-6})


def test_syncs_in_spans_and_the_counter():
    p = reading()
    assert p["sync_calls_in_spans"] == 1          # the one at 92 is outside
    assert p["host_syncs"] == 1 and p["host_syncs_total"] == 2
    assert p["host_syncs_by_span"] == {"bootstrap.recount": 1}


def test_events_without_activity_types_read_the_same():
    """torch 2.11's kineto events have neither ``activity_type`` nor
    ``is_user_annotation``: runtime calls and annotations go by name."""

    class Bare:
        def __init__(self, e):
            self._e = e

        def __getattr__(self, attr):
            if attr in ("activity_type", "is_user_annotation"):
                raise AttributeError(attr)
            return getattr(self._e, attr)

    bare = program.read_events([Bare(e) for e in BASE + PROGRAM],
                               {"atmos.indices"}, 1, TRACE)
    assert bare == reading()


def test_no_call_reads_nothing():
    assert program.read_events(PROGRAM, set(), 1, TRACE) == {}


READERS = {
    "bootstrap.thresholds_ms": 15e-6, "bootstrap.recount_ms": 20e-6,
    "indicator.idle_ms": 36e-6, "sdba.idle_ms": None,
    "host.syncs_per_call": 1.0,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers(name):
    r = run.metric_reader(name)
    value = r.read(SimpleNamespace(program=reading()))
    want = READERS[name]
    assert value == (None if want is None else pytest.approx(want))
    # a program without tracing gives nothing to read
    assert r.read(SimpleNamespace(program=None)) is None


def test_sdba_idle_reads_both_stages():
    events = [Ev("call", 0, 100), rt("cudaLaunchKernel", 5, 6, 1),
              Ev("k", 10, 20, CUDA, corr=1),
              Ev("xtt:sdba.train", 0, 40), Ev("xtt:sdba.adjust", 50, 90)]
    p = program.read_events(events, set(), 2, TRACE)
    r = run.metric_reader("sdba.idle_ms")
    # gaps [0, 10] in train, [20, 100] from inside train: 90 ns over 2 calls
    assert r.read(SimpleNamespace(program=p)) == pytest.approx(45e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_makes_the_second_stretch(bench, cpu, capsys, cell):
    res, lines = run.run_cell(bench, cell, SEED, 0.2, True, cpu,
                              time.perf_counter(),
                              config=tiny_config(bench, cell))
    assert res["correct"] is True, lines
    # no card: no host sync, no device time, the stretch all the same
    assert res["metrics"]["host.syncs_per_call"]["value"] == 0.0
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("program ")]
    p = json.loads(line[len("program "):])
    assert p["calls"] >= 1 and p["per_call_s_untraced"] > 0
    names = set(p["span_counts"])
    want = ({"sdba.adjust", "op.qdmadjust"} if cell.startswith("qdm")
            else {"indicator.call", "percentiles.doy", "op.quantile"})
    if cell in ("qdm65k.train_adjust", "tx90p4k.bootstrap"):
        want |= ({"sdba.train", "op.winquantile"} if cell.startswith("qdm")
                 else {"bootstrap.year", "bootstrap.thresholds"})
    assert want <= names
