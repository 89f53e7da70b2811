"""The program's own spans and device phases (``repro_torch/core/trace.py``)
in a run of a cell: the hooks that record them, their per-batch means,
and their place in the profiled slice.

:func:`recording` hooks the harness where a traced run records the
program, for ``bench/trace_run.py``: the recorder is on from before
set-up (the warm-up captures the traced graph), each call is tagged with
its batch (``Stager.stage``), the recorder is off around the tower graph
timed outside the server (``tracing.graph_ms``, so ``tower_device_ms``
reads as untraced), an anchor event follows the slice marker, and the
slice is a :class:`ProgramSlice`. The cell's per-layer metrics gain the
program's (``bench/program_metrics.json``), whose readers
(``bench/metrics/entry_*``, ``*_step_ms``, ``moe_*``) read the trace
through :func:`of`: ``ctx.program`` where the harness passes it, else the
slice's.
"""
from __future__ import annotations

import bisect
import contextlib
import json
from pathlib import Path

from bench import tracing

METRICS = Path(__file__).resolve().parent / "program_metrics.json"


def of(ctx):
    """The program's drained trace of the run, or None."""
    prog = getattr(ctx, "program", None)
    if prog is None:
        prog = getattr(ctx.slice, "program", None)
    return prog


def per_batch_ms(records, name: str, batches) -> float | None:
    """Mean ms a batch of the records named ``name`` (summed within a
    call) over the calls whose id is in ``batches``; None where none."""
    want = {int(b) for b in batches}
    total = {}
    for r in records:
        if r.name == name and r.call_id in want:
            total[r.call_id] = total.get(r.call_id, 0) + r.end_ns - r.start_ns
    return sum(total.values()) / len(total) / 1e6 if total else None


def host_ms(ctx, name: str) -> float | None:
    """Host ms a batch of the span ``name`` outside the profiled slice."""
    prog = of(ctx)
    return None if prog is None else per_batch_ms(
        prog.spans, name, ctx.window[ctx.outside])


def device_ms(ctx, name: str) -> float | None:
    """Device ms a batch of the phase ``name`` outside the profiled
    slice."""
    prog = of(ctx)
    return None if prog is None else per_batch_ms(
        prog.phases, name, ctx.window[ctx.outside])


class ProgramSlice(tracing.Slice):
    """A ``tracing.Slice`` that also holds the program's trace: its host
    spans on the slice's clock, and its anchored device phases placed
    after the slice marker's end (the anchor was recorded right after the
    marker, on the same stream)."""

    def __init__(self, prof, spans_ns, n_batches: int, program):
        from torch.autograd import DeviceType

        super().__init__(prof, spans_ns, n_batches)
        base = prof.profiler.kineto_results.trace_start_ns()
        marks = [e.time_range.end / 1e6 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and tracing.MARKER in e.name]
        self.program = program
        self.program_spans = sorted(
            ((s.name, (s.start_ns - base) / 1e9, (s.end_ns - base) / 1e9)
             for s in program.spans), key=lambda x: x[1])
        self.program_phases = [] if not marks else [
            (p.name, marks[-1] + p.start_ns / 1e9, marks[-1] + p.end_ns / 1e9)
            for p in program.phases if p.anchored]

    def idle_gaps(self, n: int = 10):
        """``Slice.idle_gaps``, each gap named by the innermost span, the
        harness's or the program's, that the host was in at its middle:
        ``Slice`` names a gap by the first of ``spans`` that holds it and
        bounds the slice by the first's start and the last's end, so it is
        handed every span, latest start first, between two empty spans at
        those bounds."""
        spans = self.spans
        lo, hi = spans[0][1], spans[-1][2]
        self.spans = ([("", lo, lo)]
                      + sorted(spans + self.program_spans,
                               key=lambda s: -s[1])
                      + [("", hi, hi)])
        try:
            return super().idle_gaps(n)
        finally:
            self.spans = spans

    def phase_launches(self) -> dict:
        """Kernels a batch of the slice that start inside each device
        phase (copies and memsets not counted)."""
        starts = sorted(a for name, a, _ in self.device_ops
                        if not tracing.is_copy(name))
        out = {}
        for name, a, b in self.program_phases:
            out[name] = out.get(name, 0) + (bisect.bisect_right(starts, b)
                                            - bisect.bisect_left(starts, a))
        return {k: v / self.n_batches for k, v in out.items()}


def report(prog, batches, sl=None) -> dict:
    """Each span's and phase's ms a batch, its records a batch and the
    mean ms of its k-th record within a batch, over the calls in
    ``batches`` (an ``entry.capture`` among them is a graph captured in
    the window); and with a :class:`ProgramSlice` the launches a batch
    inside each phase."""
    want = {int(b) for b in batches}

    def means(records):
        each = {}
        for r in records:
            if r.call_id in want:
                each.setdefault(r.name, {}).setdefault(r.call_id, []).append(
                    (r.end_ns - r.start_ns) / 1e6)
        out = {}
        for name, calls in sorted(each.items()):
            k = max(map(len, calls.values()))
            out[name] = {
                "ms": sum(map(sum, calls.values())) / len(calls),
                "per_batch": sum(map(len, calls.values())) / len(want),
                "each_ms": [sum(c[j] for c in calls.values() if len(c) > j)
                            / sum(1 for c in calls.values() if len(c) > j)
                            for j in range(k)]}
        return out

    out = {"batches": len(want), "host": means(prog.spans),
           "device": means(prog.phases)}
    if isinstance(sl, ProgramSlice):
        out["slice_phase_launches"] = sl.phase_launches()
    return out


class Recording:
    """What :func:`recording` gathers: the program's trace, drained from
    the recorder before each batch is staged (the previous answer is on
    the host by then, so nothing waits), and the readers' ``ctx``."""

    def __init__(self, trace):
        self._trace = trace
        self._got = trace.Drained([], [])
        self.ctx = None

    def take(self):
        """Drain the recorder into what was gathered; return all of it."""
        new = self._trace.drain()
        self._got.spans.extend(new.spans)
        self._got.phases.extend(new.phases)
        return self._got


@contextlib.contextmanager
def recording(harness, trace):
    """Hook ``harness`` (module docstring) with the recorder ``trace`` on;
    yields the :class:`Recording`. Every hook is undone on exit and the
    recorder turned off. The reading of each batch's device phases lands
    in the next batch's ``stage`` span."""
    extra = json.loads(METRICS.read_text())
    rec = Recording(trace)
    load_cell, stage = harness.load_cell, harness.Stager.stage
    graph_ms, mark = tracing.graph_ms, tracing.mark_slice_start
    reader = harness.metric_reader

    def load_cell_(name, *args, **kwargs):
        cell = load_cell(name, *args, **kwargs)
        cell.per_layer += [m for m in extra if name in m["workloads"]]
        return cell

    def stage_(self, i):
        rec.take()
        trace.tag(i)
        return stage(self, i)

    def graph_ms_(fn, n):
        trace.disable()
        try:
            return graph_ms(fn, n)
        finally:
            trace.enable()

    def mark_():
        mark()
        trace.anchor()

    def reader_(name):
        read = reader(name)

        def read_(ctx):
            rec.ctx = ctx
            return read(ctx)

        return read_

    hooks = [(harness, "load_cell", load_cell_),
             (harness.Stager, "stage", stage_),
             (tracing, "graph_ms", graph_ms_),
             (tracing, "mark_slice_start", mark_),
             (tracing, "Slice", lambda prof, spans, n: ProgramSlice(
                 prof, spans, n, rec.take())),
             (harness, "metric_reader", reader_)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in hooks]
    for obj, name, fn in hooks:
        setattr(obj, name, fn)
    trace.enable()
    try:
        yield rec
    finally:
        trace.disable()
        for obj, name, fn in saved:
            setattr(obj, name, fn)
