"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the comparison judged,
beside its limit. The same numbers end standard error.

It runs only on a card: without CUDA, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result. ``--control 1``
runs the check's control instead of the program's tower (the plain
reference one precision below the configuration's); it is never part of
a measured run.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: the reference one precision below in the "
                         "tower's place (the check's control; never a "
                         "measured run)")
    return ap.parse_args(argv)


def forbidden(modules) -> set:
    """The forbidden top-level names among ``modules``, compared whole
    (``repro_torch`` is not ``repro``)."""
    return {m.split(".")[0] for m in modules} & FORBIDDEN


def main(argv=None) -> int:
    args = parse(argv)
    # the kernels' build cache is the program's fixed directory in the
    # checkout (src/repro_torch/_build); any Triton or extension cache
    # stays in the checkout too
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "bench" / "out" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "bench" / "out" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    # one process, one busy thread: no intra-op pool competes with the
    # client loop for the host's shared cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import torch

    marks = [("import torch", time.perf_counter())]
    from bench import harness

    cell = harness.load_cell(args.workload)
    marks.append(("harness and cell", time.perf_counter()))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    torch.zeros(1, device=device).add_(1)
    torch.cuda.synchronize(device)
    marks.append(("cuda context", time.perf_counter()))
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device=device, t_start=T_START, marks=marks,
                      control=bool(args.control),
                      log=lambda m: print(f"bench: {m}", file=sys.stderr))
    found = forbidden(list(sys.modules))
    if found:
        print(f"bench: the run loaded {sorted(found)}", file=sys.stderr)
        return 3
    lines = out.pop("_lines")
    print(json.dumps(out))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
