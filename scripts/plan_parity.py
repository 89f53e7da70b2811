"""Both planners side by side: the JAX package's dry-run
(``repro.launch.dryrun.run_cell``, which lowers and compiles each cell on
512 forced host devices) and the port's (``repro_torch.launch.dryrun``,
which traces each cell on meta tensors), per device, with every roofline
term at the port's H100 constants (``repro_torch/launch/mesh.py``).

The reference runs in a subprocess of its own: ``XLA_FLAGS`` must ask for
512 host devices before JAX is imported, and ``jax.make_mesh`` is wrapped
to give Auto axes (sharding constraints refuse the Explicit axes it gives
by default). Nothing of the JAX package is edited.

    PYTHONPATH=src python scripts/plan_parity.py            # the 40 cells
    PYTHONPATH=src python scripts/plan_parity.py --cells wide-deep:serve_p99
    PYTHONPATH=src python scripts/plan_parity.py \
        --cells arctic-480b:train_4k:multipod
    PYTHONPATH=src python scripts/plan_parity.py --ref-json ref.json
    PYTHONPATH=src python scripts/plan_parity.py \
        --temps tinyllama-1.1b:decode_32k

A cell is ``arch:shape``, on the single pod, or ``arch:shape:multipod``,
on the (2, 16, 16) mesh; there the port plans an LM cell by its linear
accounting (equal to its direct trace, in a fraction of its time) and the
reference by its default, which counts each scan body (layers,
microbatches, KV chunks) once. ``--ref-json`` reuses (or, when the file
is missing, writes) the reference's results, which take about 5 min for
the 40 cells on the CPU. Prints one line a cell and a summary of the
dominant terms; ``--markdown`` also prints them as a table (``PERF.md``
section 6), and ``--out`` writes both planners' results as JSON.
``--temps`` compiles one cell of the reference with XLA's dump on and
prints the largest buffers of its temp allocation (what its
``temp_bytes`` holds).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REF_SUB = r"""
import json, sys
import jax
_make = jax.make_mesh
def _auto(shape, names, *a, **k):
    k.setdefault("axis_types", (jax.sharding.AxisType.Auto,) * len(names))
    return _make(shape, names, *a, **k)
jax.make_mesh = _auto
from repro.launch import dryrun
for cell in json.loads(sys.argv[1]):
    arch, shape, *pod = cell.split(":")
    try:
        res = dryrun.run_cell(arch, shape, multi_pod=bool(pod),
                              verbose=False)
    except Exception as e:
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    print(json.dumps({cell: res}), flush=True)
"""

TEMPS_SUB = r"""
import glob, re, sys
import jax
_make = jax.make_mesh
def _auto(shape, names, *a, **k):
    k.setdefault("axis_types", (jax.sharding.AxisType.Auto,) * len(names))
    return _make(shape, names, *a, **k)
jax.make_mesh = _auto
from repro.launch import dryrun, specs
from repro.launch.mesh import make_production_mesh
arch, shape, *pod = sys.argv[1].split(":")
mesh = make_production_mesh(multi_pod=bool(pod))
mem = dryrun._compile_cell(specs.build_cell(arch, shape, mesh),
                           mesh).memory_analysis()
print(f"temp_bytes {mem.temp_size_in_bytes} alias_bytes "
      f"{mem.alias_size_in_bytes}")
path = max(glob.glob(sys.argv[2] + "/*jit_fn*buffer-assignment.txt"))
text = open(path).read()
temp = max(re.findall(r"allocation (\d+): size (\d+), preallocated-temp",
                      text), key=lambda m: int(m[1]))
body = text.split(f"allocation {temp[0]}: ", 1)[1].split("\nallocation", 1)[0]
vals = re.findall(r"value: <\d+ (\S+) @\d+> \(size=(\d+),offset=\d+\): "
                  r"(\S+)", body)
top = sorted(vals, key=lambda v: -int(v[1]))[:int(sys.argv[3])]
for name, size, ty in top:
    print(f"{int(size):>12d}  {ty:40s} {name}")
"""

KEYS = ("hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_bytes_per_dev")


def _reference_env(flags: str = "") -> dict:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.path.join(repo, "src"),
                XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=512" + flags)


def start_reference(cells) -> subprocess.Popen:
    """Start the JAX package's ``run_cell`` on each cell of ``cells``, in
    one subprocess on 512 forced host devices; ``finish_reference`` waits
    for its results. The port can plan meanwhile."""
    return subprocess.Popen([sys.executable, "-c", REF_SUB,
                             json.dumps(cells)], env=_reference_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_reference(proc: subprocess.Popen, timeout=1800) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(stderr[-4000:])
    out = {}
    for line in stdout.splitlines():
        if line.startswith("{"):
            out.update(json.loads(line))
    return out


def run_reference(cells, timeout=1800) -> dict:
    return finish_reference(start_reference(cells), timeout)


def run_port(cells) -> dict:
    """The port's ``run_cell`` on each cell (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    out = {}
    for cell in cells:
        arch, shape, *pod = cell.split(":")
        lm = get_config(arch).family == "lm"
        out[cell] = dryrun.run_cell(arch, shape, multi_pod=bool(pod),
                                    verbose=False,
                                    accounting=lm or None)
    return out


def temps(cell: str, top: int = 12) -> str:
    """The largest buffers of the reference's temp allocation for one
    cell, from XLA's buffer assignment."""
    with tempfile.TemporaryDirectory() as dump:
        res = subprocess.run(
            [sys.executable, "-c", TEMPS_SUB, cell, dump, str(top)],
            env=_reference_env(f" --xla_dump_to={dump}"),
            capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    return res.stdout


def terms(r: dict) -> dict:
    """Compute, memory and collective seconds and the dominant term at
    the port's H100 constants."""
    from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
    t = {"compute": r["hlo_flops_per_dev"] / PEAK_FLOPS_BF16,
         "memory": r["hlo_bytes_per_dev"] / HBM_BW,
         "collective": r["collective_bytes_per_dev"] / ICI_BW}
    t["dominant"] = max(("compute", "memory", "collective"), key=t.get)
    return t


def peak_gb(r: dict) -> float:
    return r["memory_stats"]["peak_estimate_gb"]


def compare(ref: dict, port: dict) -> dict:
    """Print one line a cell (reference / port: FLOPs, bytes and
    collective bytes a device, peak GiB, dominant term, the three terms in
    ms) and return how many cells both plan and how many of them agree on
    the dominant term."""
    agree = planned = 0
    for cell in ref:
        a, b = ref[cell], port[cell]
        if not (a.get("ok") and b.get("ok")):
            why = a.get("error") or b.get("error") or ""
            print(f"{cell:38s} ref {'ok' if a.get('ok') else 'refused'} / "
                  f"port {'ok' if b.get('ok') else 'refused'}: {why[:90]}")
            continue
        planned += 1
        ta, tb = terms(a), terms(b)
        agree += ta["dominant"] == tb["dominant"]
        cols = "  ".join(f"{name} {a[k]:.3g}/{b[k]:.3g}" for name, k in
                         zip(("flops", "bytes", "coll"), KEYS))
        ms = lambda t: "/".join(f"{t[k] * 1e3:.3g}" for k in
                                ("compute", "memory", "collective"))
        print(f"{cell:38s} {cols}  peak {peak_gb(a)}/{peak_gb(b)}GiB  "
              f"{ta['dominant']}/{tb['dominant']}"
              f"{'' if ta['dominant'] == tb['dominant'] else '  MISMATCH'}"
              f"  ms c/m/x ref {ms(ta)} port {ms(tb)}")
    print(f"dominant term agrees in {agree} of {planned} cells both plan")
    return {"agree": agree, "planned": planned}


def markdown(ref: dict, port: dict) -> str:
    """A markdown table of both planners: each figure a device as
    reference / port and the port's ratio, the dominant terms."""
    rows = ["| cell | FLOPs ref / port (x) | bytes ref / port (x) | "
            "collective bytes ref / port (x) | peak GiB ref / port (x) | "
            "dominant ref / port |", "|---|---|---|---|---|---|"]
    for cell in ref:
        a, b = ref[cell], port[cell]
        if not (a.get("ok") and b.get("ok")):
            rows.append(f"| {cell} | refused: "
                        f"{'both' if not a.get('ok') and not b.get('ok') else 'ref' if not a.get('ok') else 'port'}"
                        " | | | | |")
            continue
        cols = [f"{a[k]:.3g} / {b[k]:.3g} ({b[k] / a[k]:.2f})" if a[k]
                else f"0 / {b[k]:.3g}" for k in KEYS]
        cols.append(f"{peak_gb(a)} / {peak_gb(b)} "
                    f"({peak_gb(b) / peak_gb(a):.2f})")
        da, db = terms(a)["dominant"], terms(b)["dominant"]
        cols.append(f"{da} / {db}" + ("" if da == db else " **differ**"))
        rows.append(f"| {cell} | " + " | ".join(cols) + " |")
    return "\n".join(rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="*",
                    help="arch:shape cells (default: the 40)")
    ap.add_argument("--ref-json", help="reuse or write the reference's "
                    "results here")
    ap.add_argument("--out", help="write both planners' results here")
    ap.add_argument("--markdown", action="store_true",
                    help="also print a markdown table of both")
    ap.add_argument("--temps", metavar="CELL",
                    help="print the reference's largest temp buffers for "
                    "this cell, and nothing else")
    args = ap.parse_args(argv)
    if args.temps:
        print(temps(args.temps), end="")
        return {}
    from repro_torch.configs import all_cells
    cells = args.cells or [f"{a}:{s}" for a, s in all_cells()]
    ref = {}
    if args.ref_json and os.path.exists(args.ref_json):
        with open(args.ref_json) as f:
            ref = json.load(f)
    missing = [c for c in cells if c not in ref]
    if missing:
        ref.update(run_reference(missing))
        if args.ref_json:
            with open(args.ref_json, "w") as f:
                json.dump(ref, f, indent=1)
    ref = {c: ref[c] for c in cells}
    port = run_port(cells)
    summary = compare(ref, port)
    if args.markdown:
        print(markdown(ref, port))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"reference": ref, "port": port, **summary}, f,
                      indent=1)
    return summary


if __name__ == "__main__":
    main()
