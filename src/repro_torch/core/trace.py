"""The program's span recorder: host spans of the compiled entry and
phases of the serve step, of the MoE block and of latent attention.

Process-wide and off by default: :func:`enable`, :func:`disable`,
:func:`drain`. Every instrumented point first tests the module's ``on``
flag, so while it is off a point costs that test alone (no allocation,
no clock read) and a CUDA graph captured with it off has the nodes of a
program without tracing. The compiled entry keys its graphs on the flag
too: a traced call captures a graph of its own.

**Spans** are ``Span(name, start_ns, end_ns, parent, call_id)`` on the
host's ``time.time_ns()``, the clock that a profiler's trace starts on
(``kineto_results.trace_start_ns()``). ``call_id`` numbers the compiled
calls (:func:`tag` sets the next one, e.g. to a batch index; None outside
a compiled call); ``parent`` names the enclosing span or phase:

=================  ====================================================
``entry``          one compiled call (``core/graph.py`` ``Compiled``)
``trace.read``     its reading of earlier calls' device phases
``entry.key``      the state's and inputs' flatten, signatures, address
                   key and the graph lookup
``entry.load``     the inputs' copy into the graph's buffers
``entry.replay``   ``graph.replay()`` and the launch counts
``entry.clone``    the outputs' clone out of the graph's pool
``entry.capture``  a key's first call: the eager run and the capture
                   (``CapturedGraph.capture_s`` is its duration)
=================  ====================================================

**Phases** are ``Phase(name, start_ns, end_ns, parent, call_id,
anchored)``. On a CUDA device a phase is a pair of timing events on the
current stream (``external=True``: a capture records them as event
nodes, so every replay times them anew); elsewhere it is a span.

=================  ====================================================
``step.probe``     serve step (1)-(1e): probe, blackout, touches,
                   coalescing, admission, retries (``core/server.py``)
``step.tail``      compaction and row gather before the tower, then
                   (3)-(4): placement, failover and fallback, provenance,
                   counters, ring append (two intervals a step)
``step.tower``     the ``tower_fn`` call
``step.flush``     the flush
``moe.route``      router logits, top-k (softmax, or sigmoid with the
                   selection bias), then without a mesh each
                   assignment's buffer row and gate (``index_routing``),
                   with one the dense dispatch and combine tensors and
                   their casts (``models/moe.py``), once a layer
``moe.experts``    without a mesh the copy into the capacity buffer, the
                   three batched expert matmuls and the weighted gather
                   back; with one the dispatch einsum, the three expert
                   einsums and the combine einsum; once a layer
``moe.shared``     the shared experts' SwiGLU over every token (a
                   ``DeepSeekMoEConfig``'s ``shared``), once an MoE
                   layer
``mla.project``    multi-head latent attention's q, kv_a, latent norm,
                   kv_b, RoPE and the concatenation into q and k
                   (``models/transformer.py``, an ``MLAConfig``), once a
                   layer
=================  ====================================================

A phase's times are device ns after the event :func:`anchor` recorded
(``anchored``, for calls begun after it); in calls before any anchor only
its duration holds (it starts at 0). A call's events are read at
:func:`drain` or, failing that, when the next compiled call begins
(before any graph replays again: a ``trace.read`` span), waiting for
them if they are not done; nothing else syncs for tracing. Each interval
costs one ``elapsed_time`` to read, two when anchored: a caller drains
between its calls to keep that out of them.

The recorder keeps no counters: what a compiled entry has captured is
``len(Compiled.graphs)``, kept whether or not the recorder is on (a
graph more for one shape means a key changed, e.g. a state tensor
moved), the bytes a replay copies in and clones out are
``CapturedGraph.load_bytes`` / ``clone_bytes``, and the MoE block's runs
by formulation are ``models.moe.ROUTES``.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import torch

on = False


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    call_id: Optional[int]


class Phase(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    call_id: Optional[int]
    anchored: bool


class Drained(NamedTuple):
    spans: List[Span]
    phases: List[Phase]


class _Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.phases: List[Phase] = []
        self.call: Optional[int] = None
        self.next_call = 0
        self.seq = 0              # calls begun, for the anchor
        self.call_start = 0
        self.stack = []           # open phases: (name, parent, start)
        self.eager = []           # the call's event intervals, run eagerly
        self.captured = []        # event intervals recorded by a capture
        self.unread = []          # (call, seq, intervals) not read yet
        self.anchor = None        # (event, first seq after it)


_rec = _Recorder()


def enable() -> None:
    global on
    on = True


def disable() -> None:
    global on
    on = False


def drain() -> Drained:
    """Everything recorded since the last drain (device phases read,
    waiting for them if they are not done); the recorder keeps none of
    it, nor any open phase."""
    _read()
    out = Drained(_rec.spans, _rec.phases)
    _rec.spans, _rec.phases = [], []
    _rec.stack.clear()
    return out


def tag(call_id: int) -> None:
    """Number the next compiled call ``call_id`` (later ones count on)."""
    _rec.next_call = call_id


def anchor() -> None:
    """Record the reference event of later calls' device phases on the
    current stream, e.g. right after a profiler's marker kernel."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    _rec.anchor = (ev, _rec.seq + 1)


# ------------------------------------------------------ the compiled entry
def begin_call() -> int:
    """Open a compiled call: read the device phases of earlier calls (a
    ``trace.read`` span), then number the call. Returns the clock at which
    its next span starts."""
    r = _rec
    t0 = time.time_ns()
    had = bool(r.unread or r.eager)
    _read()
    r.call, r.next_call, r.seq = r.next_call, r.next_call + 1, r.seq + 1
    r.call_start = t0
    r.stack.clear()
    if not had:
        return t0
    t1 = time.time_ns()
    r.spans.append(Span("trace.read", t0, t1, "entry", r.call))
    return t1


def span(name: str, t0: int, t1: Optional[int] = None) -> int:
    """Record the call's span ``name`` from ``t0`` to ``t1`` (None: now);
    returns its end."""
    t1 = time.time_ns() if t1 is None else t1
    _rec.spans.append(Span(name, t0, t1, "entry", _rec.call))
    return t1


def end_call() -> None:
    """Close the call: its ``entry`` span; its eager phases await reading."""
    r = _rec
    r.spans.append(Span("entry", r.call_start, time.time_ns(), None, r.call))
    if r.eager:
        r.unread.append((r.call, r.seq, r.eager))
        r.eager = []
    r.call = None


def take_captured() -> list:
    """The event intervals the last capture recorded (a graph keeps them
    and hands them to :func:`replayed` after each replay)."""
    out, _rec.captured = _rec.captured, []
    return out


def replayed(intervals: list) -> None:
    """A graph holding ``intervals`` replayed in the current call."""
    if intervals:
        _rec.unread.append((_rec.call, _rec.seq, intervals))


# ------------------------------------------------------------------ phases
def begin(name: str, device: torch.device) -> None:
    """Open the phase ``name`` of work on ``device``: a timing event on
    the current stream of a CUDA device, the host clock elsewhere."""
    r = _rec
    parent = (r.stack[-1][0] if r.stack
              else None if r.call is None else "entry")
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True, external=True)
        start.record()
        r.stack.append((name, parent, start))
    else:
        r.stack.append((name, parent, time.time_ns()))


def end(name: str) -> None:
    """Close the innermost open phase, which must be ``name``."""
    r = _rec
    top, parent, start = r.stack.pop()
    if top != name:
        raise RuntimeError(f"phase {name!r} ended inside phase {top!r}")
    if isinstance(start, int):
        r.spans.append(Span(name, start, time.time_ns(), parent, r.call))
        return
    stop = torch.cuda.Event(enable_timing=True, external=True)
    stop.record()
    iv = (name, parent, start, stop)
    if torch.cuda.is_current_stream_capturing():
        r.captured.append(iv)
    else:
        r.eager.append(iv)


def _read() -> None:
    r = _rec
    if r.eager:
        r.unread.append((r.call, r.seq, r.eager))
        r.eager = []
    for call, seq, ivs in r.unread:
        # one stream: the last interval's end event was recorded last
        ivs[-1][3].synchronize()
        anchored = r.anchor is not None and seq >= r.anchor[1]
        for name, parent, b, e in ivs:
            a = round(r.anchor[0].elapsed_time(b) * 1e6) if anchored else 0
            r.phases.append(Phase(name, a, a + round(b.elapsed_time(e) * 1e6),
                                  parent, call, anchored))
    r.unread = []
