"""The program's spans in a run (``bench/program_trace.py``): a tiny cell
driven on the CPU with the recorder hooked in stays correct and gives
every step phase under its batch's call; each program metric has its
reader, moves an end-to-end metric its cells report and reads the mean a
batch outside the slice (nothing where the run has no program trace);
and the slice names a gap by the innermost span and counts each phase's
launches."""
import json
import time
import types

import numpy as np
import pytest
import torch

from bench import harness, program_trace
from repro_torch.core import trace

DATA = harness.BENCH / "tests" / "data"
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
PROGRAM = json.loads(program_trace.METRICS.read_text())
# each program metric's span or phase
READS = {"entry_key_ms": "entry.key", "entry_load_ms": "entry.load",
         "entry_replay_ms": "entry.replay", "entry_clone_ms": "entry.clone",
         "probe_step_ms": "step.probe", "tail_step_ms": "step.tail",
         "tower_step_ms": "step.tower", "flush_step_ms": "step.flush",
         "moe_route_ms": "moe.route", "moe_experts_ms": "moe.experts"}


def test_recorded_cpu_run_is_correct_and_tags_each_batch():
    cell = harness.load_cell("sasrec.tiny", bench_json=DATA / "bench.json",
                             traffic_dir=DATA / "traffic")
    with program_trace.recording(harness, trace) as rec:
        out = harness.run(cell, 2 ** 31 + 99, 0.2, False,
                          device=torch.device("cpu"),
                          t_start=time.perf_counter(), log=lambda m: None)
    prog = rec.take()
    assert not trace.on and harness.load_cell.__module__ == "bench.harness"
    assert out["correct"], out["checks"]
    calls = sorted({s.call_id for s in prog.spans})
    assert calls == list(range(len(calls))) and len(calls) > 2
    rep = program_trace.report(prog, calls[2:])
    host = rep["host"]
    assert host["step.tail"]["per_batch"] == 2
    assert host["step.flush"]["per_batch"] == 2      # the step's and the tail
    assert len(host["step.flush"]["each_ms"]) == 2
    for name in ("entry", "step.probe", "step.tower"):
        assert host[name]["per_batch"] == 1 and host[name]["ms"] > 0


def _prog(name, source):
    rec = trace.Span if source == "host_clock" else (
        lambda *a: trace.Phase(*a, True))
    # two records of batch 3 and one of batch 4 (in the slice), one of 5
    recs = [rec(name, 0, 2_000_000, "entry", 3),
            rec(name, 5_000_000, 6_000_000, "entry", 3),
            rec(name, 0, 9_000_000, "entry", 4),
            rec(name, 0, 1_000_000, "entry", 5),
            rec("other", 0, 7_000_000, "entry", 5)]
    spans, phases = (recs, []) if source == "host_clock" else ([], recs)
    return trace.Drained(spans, phases)


@pytest.mark.parametrize("metric", PROGRAM, ids=[m["name"] for m in PROGRAM])
def test_program_metric_reads_the_mean_outside_the_slice(metric):
    moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moved and set(metric["workloads"]) <= set(moved[0]["workloads"])
    assert metric["layer"] in {m["layer"] for m in BENCH["per_layer"]}
    read = harness.metric_reader(metric["name"])
    name = READS[harness.base_name(metric["name"])]
    ctx = types.SimpleNamespace(window=np.array([3, 4, 5]),
                                outside=np.array([True, False, True]),
                                slice=None)
    assert read(ctx) is None
    ctx.program = _prog(name, metric["source"])
    assert read(ctx) == pytest.approx((3.0 + 1.0) / 2)


def _event(name, a_us, b_us):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=a_us, end=b_us))


def test_slice_names_gaps_by_the_innermost_span_and_counts_phase_launches():
    base = 10 ** 12
    at = lambda us: base + int(us * 1e3)
    ops = [_event("spin_kernel", 0, 10), _event("probe_kernel", 20, 30),
           _event("Memcpy DtoD", 31, 32), _event("gemm", 40, 50),
           _event("sort", 80, 90)]
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            trace_start_ns=lambda: base)), events=lambda: ops)
    harness_spans = [("stage", at(12), at(15)), ("call", at(15), at(95)),
                     ("answer", at(95), at(100))]
    prog = trace.Drained(
        [trace.Span("entry", at(15.5), at(94.5), None, 7),
         trace.Span("entry.clone", at(55), at(78), "entry", 7)],
        [trace.Phase("step.probe", 8_000, 21_000, "entry", 7, True),
         trace.Phase("step.tower", 29_000, 41_000, "entry", 7, True),
         trace.Phase("step.tower", 0, 1, "entry", 6, False)])
    sl = program_trace.ProgramSlice(prof, harness_spans, 1, prog)
    gaps = [(label, round(s * 1e6, 6)) for label, s in sl.idle_gaps()]
    assert gaps == [("host in entry.clone", 30), ("host in answer", 10),
                    ("host in entry", 8), ("host in entry", 8),
                    ("host in entry", 1)]
    assert sl.phase_launches() == {"step.probe": 1, "step.tower": 1}
