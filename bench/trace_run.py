"""Run one cell once as ``bench/run.py`` does, with the program's span
recorder on, and print the program's split of a batch.

    python3 bench/trace_run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The harness is hooked where a traced run records the program
(``bench/program_trace.py``): the recorder is on from before set-up, each
call is tagged with its batch, the tower graph timed outside the server
is captured with it off, device phases are anchored after the slice
marker, and with ``--trace 1`` the idle gaps of the breakdown are named
by the innermost span, the program's included, and the per-layer metrics
gain the program's (``bench/program_metrics.json``). After ``run.py``'s
result line comes one more JSON line: each program span's host ms and
each phase's device ms a batch (and its records a batch) over the
window's batches (with ``--trace 1`` those outside the profiled slice),
and the launches a batch inside each phase of the slice. Set against ``bench/run.py``'s line of the same cell and seed,
it gives what the recorder costs.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import run  # noqa: E402  (its clock of set-up starts here)


def main(argv=None) -> int:
    import json

    from bench import harness, program_trace
    from repro_torch.core import trace

    args = run.parse(argv)
    with program_trace.recording(harness, trace) as rec:
        rc = run.main(argv)
    if rc:
        return rc
    ctx, prog = rec.ctx, rec.take()
    if ctx is not None:
        batches = ctx.window[ctx.outside]
    else:
        first = harness.load_cell(args.workload).traffic.warmup_batches
        batches = sorted({s.call_id for s in prog.spans
                          if s.call_id is not None and s.call_id >= first})
    print(json.dumps(program_trace.report(
        prog, batches, None if ctx is None else ctx.slice)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
