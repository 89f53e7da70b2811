"""The traced run's reductions: the harness's host spans, the device trace
of a bounded slice of the window (``torch.profiler``), and CUDA-event
timing of a call with the host's enqueue hidden.

Spans are the harness's own, around the calls into each layer: ``stage``
(ids, features, clock and failure mask put on the device), ``call`` (the
compiled entry, up to its return), ``answer`` (the answer's copy to the
host and the wait for it). Spans inside the program are a later change.
"""
from __future__ import annotations

import torch

# kernel name fragments of each hand-written kernel
KERNELS = {"cache_probe": ("probe_kernel",),
           "embedding_bag": ("bag_kernel",),
           "flash_attention": ("fa_kernel", "fa_wgmma_kernel")}


# the kernel ``mark_slice_start`` launches: the device's work after it is
# the slice's
MARKER = "spin_kernel"


def mark_slice_start() -> None:
    """Put a marker on the device's timeline: a one-cycle spin kernel."""
    torch.cuda._sleep(1)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def kernel_of(name: str):
    low = name.lower()
    for k, frags in KERNELS.items():
        if any(f in low for f in frags):
            return k
    return None


class Slice:
    """What the profiler saw over ``n_batches`` batches: each device op
    (name, start, end in s) and each harness span (name, start, end), on
    the profiler's clock: its trace starts at ``trace_start_ns`` of the
    host's real-time clock, on which the harness took its spans."""

    def __init__(self, prof, spans_ns, n_batches: int):
        from torch.autograd import DeviceType

        self.n_batches = n_batches
        base = prof.profiler.kineto_results.trace_start_ns()
        self.spans = sorted((name, (a - base) / 1e9, (b - base) / 1e9)
                            for name, a, b in spans_ns)
        self.spans.sort(key=lambda x: x[1])
        ops = sorted(((e.name, e.time_range.start / 1e6,
                       e.time_range.end / 1e6) for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda x: x[1])
        # the slice's work follows its marker; the profiler's warm-up
        # batches ran before it
        marks = [end for name, _, end in ops if MARKER in name]
        lo = marks[-1] if marks else self.spans[0][1]
        self.device_ops = [o for o in ops if o[1] >= lo]

    def inside_spans(self) -> float:
        """Share of the device ops' time that falls inside a batch's span
        (stage start to answer end): 1 where the two clocks agree."""
        total = sum(b - a for _, a, b in self.device_ops) or 1.0
        starts = [x for n, x, _ in self.spans if n == "stage"]
        ends = [y for n, _, y in self.spans if n == "answer"]
        inside = sum(min(b, e) - max(a, s) for _, a, b in self.device_ops
                     for s, e in zip(starts, ends) if a < e and b > s)
        return inside / total

    def busy_intervals(self):
        out = []
        for _, a, b in self.device_ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def window_s(self) -> float:
        """From the first span's start to the last's end."""
        return self.spans[-1][2] - self.spans[0][1]

    def kernel_seconds(self, kernel: str) -> float:
        return sum(b - a for n, a, b in self.device_ops
                   if kernel_of(n) == kernel)

    def kernel_launches(self, kernel: str) -> int:
        return sum(1 for n, _, _ in self.device_ops if kernel_of(n) == kernel)

    def launches(self) -> int:
        return sum(1 for n, _, _ in self.device_ops if not is_copy(n))

    def call_device_s(self) -> float:
        """Device time of the program's calls: every kernel, memset and
        device-to-device copy; not the harness's host copies."""
        return sum(b - a for n, a, b in self.device_ops
                   if not (n.startswith("Memcpy HtoD")
                           or n.startswith("Memcpy DtoH")))

    def top_ops(self, n: int = 10):
        by = {}
        for name, a, b in self.device_ops:
            key = name[:96]
            by[key] = by.get(key, 0.0) + (b - a)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest gaps between device work inside the slice, each
        named by the harness span the host was in at the gap's middle."""
        lo, hi = self.spans[0][1], self.spans[-1][2]
        busy = [(max(a, lo), min(b, hi)) for a, b in self.busy_intervals()
                if b > lo and a < hi]
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for a, b in gaps:
            mid = (a + b) / 2
            label = next((f"host in {s}" for s, x, y in self.spans
                          if x <= mid <= y), "host between spans")
            out.append([label, b - a])
        return sorted(out, key=lambda g: -g[1])[:n]


def graph_ms(fn, n: int) -> float:
    """Device ms of one ``fn()``: captured once as a CUDA graph, then
    ``n`` replays timed with CUDA events, so the host's enqueue of its
    kernels is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    del graph
    return ms
