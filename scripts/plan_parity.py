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
    PYTHONPATH=src python scripts/plan_parity.py --cells ercache
    PYTHONPATH=src python scripts/plan_parity.py --ref-json ref.json
    PYTHONPATH=src python scripts/plan_parity.py \
        --temps tinyllama-1.1b:decode_32k
    PYTHONPATH=src python scripts/plan_parity.py \
        --ops granite-moe-1b-a400m:decode_32k \
        --overrides '{"n_layers": 1, "unroll_scans": true}' --top 25

A cell is ``arch:shape``, on the single pod, or ``arch:shape:multipod``,
on the (2, 16, 16) mesh, or ``ercache``: the ERCache serve cell
(``run_ercache_cell``) on the single pod, the reference's layer scan
unrolled so that each layer counts. On the multi-pod mesh the port plans
an LM cell by its linear accounting (equal to its direct trace, in a
fraction of its time) and the reference by its default, which counts
each scan body (layers, microbatches, KV chunks) once. ``--ref-json`` reuses (or, when the file
is missing, writes) the reference's results, which take about 5 min for
the 40 cells on the CPU. Prints one line a cell and a summary of the
dominant terms; ``--markdown`` also prints them as a table (``PERF.md``
section 6; with ``--before`` an earlier ``--out`` file's port ratios
beside them), and ``--out`` writes both planners' results as JSON.
``--temps`` compiles one cell of the reference with XLA's dump on and
prints the largest buffers of its temp allocation (what its
``temp_bytes`` holds). ``--ops`` is the diagnosis view of one cell: the
reference's post-SPMD collectives (kind, ``~`` where the value is a bf16
one its host compile widened to float32, operand MiB, group, the jax op
that made each, operand -> result shapes, the gathered dims and replica
groups), its FLOPs by (opcode, jax op) and largest-FLOP instructions
(counted as its cost analysis counts them; a scan body once) and its temp
buffers, beside the port's tallies of the same cell
(``LayoutCounter(tally=True)``): FLOPs by aten op, each collective with
the aten op that made it (``*`` involuntary), and the tensors live at
its peak. An LM cell's figures are its accounting's, solved from
variants of 1 and 2 layers (and 1 and 2 microbatches): ``--overrides``
compiles and traces one such variant on both sides. Each reference result
also carries what its compile for host devices adds, through the same
accounting: ``host_convert_flops``, the FLOPs its cost analysis gives the
converts XLA inserts itself (no jax op in their metadata), and
``host_f32_collective_bytes``, the wire bytes its float32 widening of
bf16 values adds to its collectives.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

AUTO_MESH = r"""
import collections, glob, json, os, re, sys
import jax
_make = jax.make_mesh
def _auto(shape, names, *a, **k):
    k.setdefault("axis_types", (jax.sharding.AxisType.Auto,) * len(names))
    return _make(shape, names, *a, **k)
jax.make_mesh = _auto
from repro.launch import dryrun, specs
from repro.launch.mesh import make_production_mesh
"""

# What the reference's compile for host devices adds, summed through the
# LM accounting as its other figures (by wrapping its measure; nothing is
# edited): the FLOPs XLA's cost analysis gives the converts it inserts
# itself (no jax op in their metadata), where the CPU computes a bf16
# product or update in float32, and the wire bytes of the collectives
# that carry a bf16 value so widened (an f32 operand made, through copies
# and reshapes, by a convert from bf16): half of theirs.
HOST = r"""
LINE = re.compile(r"^\s+(ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^)]*\)|\S+)\s+"
                  r"([\w\-]+)\((.*)$")
MOVES = {"bitcast", "copy", "transpose", "reshape", "slice",
         "dynamic-slice", "broadcast"}
def host_figures(text, n_devices):
    comps, cur, flops = {}, None, 0.0
    for line in text.splitlines():
        if line.rstrip().endswith("{") and not line.startswith(" "):
            head = line.split()
            cur = comps.setdefault(head[1 if head[0] == "ENTRY" else 0]
                                   .lstrip("%"), {})
            continue
        m = LINE.match(line)
        if not m or cur is None:
            continue
        root, name, ty, opc, rest = m.groups()
        calls = re.search(r"calls=%([\w.\-]+)", rest)
        cur[name] = (ty, opc, re.findall(r"%([\w.\-]+)",
                                         dryrun._balanced_args(rest, 0)),
                     calls.group(1) if calls else None, rest)
        if root:
            cur[None] = name
        if opc == "convert" and "op_name=" not in rest:
            flops += dryrun._type_bytes(ty) / dryrun._DTYPE_BYTES[
                ty.split("[")[0]]
    def widened(comp, name):
        ty, opc, ops, calls, _ = comps[comp][name]
        if not ty.startswith("f32["):
            return False
        if opc == "convert":
            return comps[comp][ops[0]][0].startswith("bf16[")
        if opc in MOVES and ops:
            return widened(comp, ops[0])
        return opc == "fusion" and widened(calls, comps[calls][None])
    wire, names = 0.0, set()
    for comp, instrs in comps.items():
        for name, instr in instrs.items():
            if name is None:
                continue
            ty, opc, ops, _, rest = instr
            base = opc[:-6] if opc.endswith("-start") else opc
            if base not in dryrun._COLLECTIVES or opc.endswith("-done"):
                continue
            n = dryrun._group_size(rest, n_devices)
            for op in ops:
                if op in instrs and widened(comp, op):
                    wire += dryrun._type_bytes(instrs[op][0]) / 2 \
                        * dryrun._wire_factor(base, n)
                    names.add(name)
    return flops, wire, names
_measure, _acct, _compile = (dryrun._measure, dryrun.lm_accounting,
                             dryrun._compile_cell)
host = {}
def _measure_host(compiled, n_devices=256):
    out = _measure(compiled, n_devices)
    out["host_convert_flops"], out["host_f32_collective_bytes"] = \
        host_figures(compiled.as_text(), n_devices)[:2]
    return out
def _acct_host(*a, **k):
    out = _acct(*a, **k)
    host["acct"] = (out["host_convert_flops"],
                    out["host_f32_collective_bytes"])
    return out
def _compile_host(cell, mesh):
    compiled = _compile(cell, mesh)
    host["cell"] = host_figures(compiled.as_text(), mesh.size)[:2]
    return compiled
dryrun._measure, dryrun.lm_accounting, dryrun._compile_cell = (
    _measure_host, _acct_host, _compile_host)
"""

REF_SUB = AUTO_MESH + HOST + r"""
import dataclasses
_config = dryrun.get_config
for cell in json.loads(sys.argv[1]):
    host.clear()
    try:
        if cell == "ercache":     # its layer scan unrolled: each layer counted
            _bytes = dryrun.collective_bytes
            def _bytes_host(text, n_devices):
                host["cell"] = host_figures(text, n_devices)[:2]
                return _bytes(text, n_devices)
            dryrun.get_config = lambda a: dataclasses.replace(
                _config(a), unroll_scans=True)
            dryrun.collective_bytes = _bytes_host
            try:
                res = dryrun.run_ercache_cell(verbose=False)
            finally:
                dryrun.get_config, dryrun.collective_bytes = _config, _bytes
        else:
            arch, shape, *pod = cell.split(":")
            res = dryrun.run_cell(arch, shape, multi_pod=bool(pod),
                                  verbose=False)
        (res["host_convert_flops"],
         res["host_f32_collective_bytes"]) = host.get("acct", host["cell"])
    except Exception as e:
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    print(json.dumps({cell: res}), flush=True)
"""

# argv: cell, dump dir, top, overrides (JSON)
COMPILE = r"""
arch, shape, *pod = sys.argv[1].split(":")
top = int(sys.argv[3])
overrides = json.loads(sys.argv[4]) or None
mesh = make_production_mesh(multi_pod=bool(pod))
compiled = dryrun._compile_cell(specs.build_cell(arch, shape, mesh,
                                                 overrides), mesh)
"""

TEMPS = r"""
mem = compiled.memory_analysis()
print(f"temp_bytes {mem.temp_size_in_bytes} alias_bytes "
      f"{mem.alias_size_in_bytes}")
path = max(glob.glob(sys.argv[2] + "/*buffer-assignment.txt"),
           key=os.path.getsize)           # the cell's module, the largest
text = open(path).read()
temp = max(re.findall(r"allocation (\d+): size (\d+), preallocated-temp",
                      text), key=lambda m: int(m[1]))
body = text.split(f"allocation {temp[0]}: ", 1)[1].split("\nallocation", 1)[0]
vals = re.findall(r"value: <\d+ (\S+) @\d+> \(size=(\d+),offset=\d+\): "
                  r"(\S+)", body)
for name, size, ty in sorted(vals, key=lambda v: -int(v[1]))[:top]:
    print(f"{int(size):>12d}  {ty:40s} {name}")
"""

# the post-SPMD HLO's collectives and largest-FLOP instructions (FLOPs as
# XLA's cost analysis counts them: 2 M N K a dot, one an element of an
# element-wise op's output or of a reduce's input; a scan body once)
OPS = r"""
text = compiled.as_text()
cost = compiled.cost_analysis() or {}
INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^)]*\)|\S+)\s+"
                   r"([\w\-]+)\((.*)$")
ELEM = {"add", "subtract", "multiply", "divide", "maximum", "minimum",
        "compare", "select", "and", "or", "xor", "not", "negate", "abs",
        "convert", "clamp", "remainder", "floor", "ceil", "sign",
        "round-nearest-even", "round-nearest-afz", "shift-left",
        "shift-right-logical", "shift-right-arithmetic", "is-finite"}
def dims(ty):
    m = re.search(r"\[([0-9,]*)\]", ty)
    return [int(d) for d in m.group(1).split(",") if d] if m else []
def size(ty):
    out = 1
    for d in dims(ty):
        out *= d
    return out
def op_name(rest):
    m = re.search(r'op_name="([^"]*)"', rest)
    return m.group(1).replace("jit(fn)/", "") if m else "?"
types, instrs = {}, []
for line in text.splitlines():
    m = INSTR.match(line)
    if m:
        types[m.group(1)] = m.group(2)
        instrs.append(m.groups())
flops, colls = [], []
wide = host_figures(text, mesh.size)[2]
for name, ty, opc, rest in instrs:
    f = 0.0
    first = re.match(r"\s*%([\w.\-]+)", rest)
    if opc == "dot":
        k = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", rest)
        ld = dims(types.get(first.group(1), ""))
        f = 2.0 * size(ty)
        for d in (k.group(1).split(",") if k and k.group(1) else []):
            f *= ld[int(d)]
    elif opc in ELEM and dims(ty):
        f = float(size(ty))
    elif opc == "reduce" and first:
        f = float(size(types.get(first.group(1), "")))
    if f:
        flops.append((f, opc, ty, op_name(rest)))
    base = opc[:-6] if opc.endswith("-start") else opc
    if base in dryrun._COLLECTIVES and not opc.endswith("-done"):
        args = dryrun._balanced_args(rest, 0)
        shapes = " ".join(types.get(nm, "?") for nm in
                          re.findall(r"%([\w.\-]+)", args))
        dm = re.search(r"dimensions=\{([0-9,]*)\}", rest)
        rg = re.search(r"replica_groups=(\S+?),? ", rest)
        shapes += f" -> {ty}" + (f" dims {dm.group(1)}" if dm else "") \
            + (f" groups {rg.group(1)}" if rg else "")
        colls.append((base + ("~" if name in wide else ""),
                      dryrun._type_bytes(shapes.split(" -> ")[0]),
                      shapes, dryrun._group_size(rest, mesh.size),
                      op_name(rest)))
print(f"== reference {sys.argv[1]}, overrides {overrides}")
print(f"-- FLOPs: cost analysis {cost.get('flops', 0.0):.4g}, the "
      f"instructions below {sum(f[0] for f in flops):.4g}; by (opcode, "
      f"jax op), top {top}")
by_op = collections.defaultdict(float)
for f, opc, ty, nm in flops:
    by_op[(opc, nm)] += f
for (opc, nm), f in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]:
    print(f"{f:12.4g}  {opc:10s} {nm}")
print(f"-- largest-FLOP instructions, top {top}")
for f, opc, ty, nm in sorted(flops, key=lambda r: -r[0])[:top]:
    print(f"{f:12.4g}  {opc:10s} {ty:36s} {nm}")
wire = collections.defaultdict(float)
for kind, b, shapes, g, nm in colls:
    wire[kind.rstrip("~")] += b * dryrun._wire_factor(kind.rstrip("~"), g)
kinds = {k: (sum(c[0].rstrip("~") == k for c in colls), f"{w:.3g} B")
         for k, w in wire.items()}
print(f"-- collectives (count, wire bytes) {kinds}: kind (~ a float32 "
      f"widening of bf16), operand MiB, group, jax op, operand")
for kind, b, shapes, g, nm in colls:
    print(f"{kind:18s} {b / 2**20:10.4f} {g:4d}  {nm[-60:]:60s} "
          f"{shapes[:120]}")
print(f"-- temp buffers, top {top}")
"""

KEYS = ("hlo_flops_per_dev", "hlo_bytes_per_dev", "collective_bytes_per_dev")

# Differences that the reference's compile for host devices makes, named
# (tests/test_torch_plan_parity.py quotes the reference's HLO lines for
# each): on an LM's decode cells (single pod) its cache is held in float32
# (F32_CACHE: the port's peak plus twice its aliased bytes is held to the
# reference's) and its converts count as FLOPs (HOST_CONVERTS: the port's
# FLOPs are held to the reference's less ``host_convert_flops``); on every
# LM cell its collectives carry bf16 values in float32 (HOST_F32: the
# port's collective bytes are also held to the reference's less
# ``host_f32_collective_bytes``); its one-hot token embedding on Granite's
# undivided vocabulary is converted to float32 (the float32 half, two
# bytes an element, is added to the port's peak) and Arctic's expert
# weight stacks are float32 copies in its temp (their bytes are added).
DECODE_SHAPES = ("decode_32k", "long_500k")
# the ERCache serve cell (``run_ercache_cell``, TinyLlama, B = 4,096, on the
# production mesh): a cell of its own for ``--cells``, not of the 40
ERCACHE = "ercache"
ONE_HOT_EMBED = {"granite-moe-1b-a400m:prefill_32k": 65536 * 49155 * 2}
F32_WEIGHTS = {"arctic-480b:prefill_32k": 3 * 2440560640}


def lm_decode(cell: str) -> bool:
    """A single-pod LM decode cell: F32_CACHE and HOST_CONVERTS apply."""
    parts = cell.split(":")
    return len(parts) == 2 and parts[1] in DECODE_SHAPES


def held(cell: str, a: dict, b: dict) -> dict:
    """The port's FLOPs and peak over the figures the named differences
    hold them to (module constants; the reference's figures elsewhere),
    and its collective bytes over the reference's less what its float32
    widening of bf16 values adds (``host_f32_collective_bytes``; shown,
    not held: the test holds the reference's own)."""
    flops = a["hlo_flops_per_dev"]
    peak = peak_gb(b) + (ONE_HOT_EMBED.get(cell, 0)
                         + F32_WEIGHTS.get(cell, 0)) / 2**30
    if lm_decode(cell):
        flops -= a["host_convert_flops"]
        peak += 2 * b["memory_stats"]["alias_bytes"] / 2**30
    coll = a["collective_bytes_per_dev"] \
        - a.get("host_f32_collective_bytes", 0.0)
    return {"flops": b["hlo_flops_per_dev"] / flops,
            "peak": peak / peak_gb(a),
            "coll": b["collective_bytes_per_dev"] / coll if coll else 0.0}


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
    """The port's ``run_cell`` on each cell (module docstring), and its
    ``run_ercache_cell`` on the production mesh for ``ercache``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    out = {}
    for cell in cells:
        if cell == ERCACHE:
            out[cell] = dryrun.run_ercache_cell(verbose=False)
            continue
        arch, shape, *pod = cell.split(":")
        lm = get_config(arch).family == "lm"
        out[cell] = dryrun.run_cell(arch, shape, multi_pod=bool(pod),
                                    verbose=False,
                                    accounting=lm or None)
    return out


def _compile_reference(body: str, cell: str, top: int,
                       overrides=None, prelude: str = "") -> str:
    """Compile one cell of the reference with XLA's dump on and run
    ``body`` (``OPS``, ``TEMPS``) over it, ``prelude`` (``HOST``) before
    the compile; returns what it prints."""
    with tempfile.TemporaryDirectory() as dump:
        res = subprocess.run(
            [sys.executable, "-c", AUTO_MESH + prelude + COMPILE + body,
             cell, dump,
             str(top), json.dumps(overrides or {})],
            env=_reference_env(f" --xla_dump_to={dump}"),
            capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    return res.stdout


def temps(cell: str, top: int = 12) -> str:
    """The largest buffers of the reference's temp allocation for one
    cell, from XLA's buffer assignment."""
    return _compile_reference(TEMPS, cell, top)


def _mib(x: float) -> str:
    return f"{x / 2**20:10.2f} MiB"


def ops(cell: str, top: int = 15, overrides=None) -> str:
    """The diagnosis view of one cell: the reference's post-SPMD
    collectives (kind, operand, group, jax op), its largest-FLOP
    instructions and its temp buffers, beside the port's tallies of the
    same cell (``LayoutCounter(tally=True)``): FLOPs by aten op, each
    collective with the aten op that made it, and the live tensors at the
    peak. ``overrides`` (config fields) go to both; an LM cell's figures
    are its accounting's, so ``{"n_layers": 1, "unroll_scans": true}``
    shows one layer as the accounting sees it."""
    from collections import defaultdict

    from repro_torch.launch import dryrun, specs
    ref = _compile_reference(OPS + TEMPS, cell, top, overrides, HOST)
    arch, shape, *pod = cell.split(":")
    mesh = dryrun._production_mesh(bool(pod))
    c = specs.build_cell(arch, shape, mesh, overrides)
    res = dryrun.trace(c.fn, c.args, c.in_specs, mesh.shape, tally=True)
    counter = res["counter"]
    lines = [ref.rstrip(), f"== port {cell}, overrides {overrides}",
             f"-- FLOPs {res['flops']:.4g} by aten op, top {top}"]
    for op, f in sorted(counter.flops_by_op.items(),
                        key=lambda kv: -kv[1])[:top]:
        lines.append(f"{f:12.4g}  {op}")
    kinds = {k: (sum(r[0] == k for r in counter.records),
                 f"{res['coll_' + k]:.3g} B")
             for k in dict.fromkeys(r[0] for r in counter.records)}
    lines.append(f"-- collectives (count, wire bytes) {kinds}, "
                 f"{res['involuntary']} involuntary: kind, operand MiB a "
                 "device, group, aten op (* involuntary), count")
    rows = defaultdict(int)
    for kind, operand, group, op, inv, shp in counter.records:
        rows[(kind, operand, group, op + (" *" if inv else ""), shp)] += 1
    for (kind, operand, group, op, shp), k in sorted(
            rows.items(), key=lambda kv: -kv[0][1] * kv[1]):
        lines.append(f"{kind:18s} {operand / 2**20:10.4f} {group:4d}  "
                     f"{op:24s} x{k:<4d} {list(shp)}")
    lines.append(f"-- live at the peak ({_mib(res['peak'])} a device), "
                 f"top {top}: bytes a device, shape, dtype, aten op")
    for nbytes, shp, dt, op in sorted(counter.at_peak,
                                      key=lambda r: -r[0])[:top]:
        lines.append(f"{_mib(nbytes)}  {str(list(shp)):32s} {dt:14s} {op}")
    return "\n".join(lines) + "\n"


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


def markdown(ref: dict, port: dict, before: dict = None) -> str:
    """A markdown table of both planners: each figure a device as
    reference / port and the port's ratio (``before``, an earlier run's
    port results: its ratio too, as "was"), the dominant terms, and the
    FLOPs and peak ratios under the named differences where they apply
    (``held``)."""
    rows = ["| cell | FLOPs ref / port (x) | bytes ref / port (x) | "
            "collective bytes ref / port (x) | peak GiB ref / port (x) | "
            "dominant ref / port | named: FLOPs, peak x | collectives "
            "x, bf16 |",
            "|---|---|---|---|---|---|---|---|"]
    for cell in ref:
        a, b = ref[cell], port[cell]
        if not (a.get("ok") and b.get("ok")):
            rows.append(f"| {cell} | refused: "
                        f"{'both' if not a.get('ok') and not b.get('ok') else 'ref' if not a.get('ok') else 'port'}"
                        " | | | | | | |")
            continue
        was = (before or {}).get(cell) or {}
        was_ok = was.get("ok")

        def ratio(new, old, want):
            return f"({new / want:.2f}" + (
                f"; was {old / want:.2f})" if was_ok else ")")
        cols = [f"{a[k]:.3g} / {b[k]:.3g} "
                + ratio(b[k], was.get(k, 0.0), a[k]) if a[k]
                else f"0 / {b[k]:.3g}" for k in KEYS]
        cols.append(f"{peak_gb(a)} / {peak_gb(b)} " + ratio(
            peak_gb(b), peak_gb(was) if was_ok else 0.0, peak_gb(a)))
        da, db = terms(a)["dominant"], terms(b)["dominant"]
        cols.append(f"{da} / {db}" + ("" if da == db else " **differ**"))
        named = lm_decode(cell) or cell in ONE_HOT_EMBED \
            or cell in F32_WEIGHTS
        h = held(cell, a, b)
        cols.append(f"{h['flops']:.2f}, {h['peak']:.2f}" if named else "")
        cols.append(f"{h['coll']:.2f}" + (
            f"; was {held(cell, a, was)['coll']:.2f}" if was_ok else "")
            if a.get("host_f32_collective_bytes") else "")
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
    ap.add_argument("--before", help="with --markdown: an earlier --out "
                    "file, whose port ratios the table gives as 'was'")
    ap.add_argument("--temps", metavar="CELL",
                    help="print the reference's largest temp buffers for "
                    "this cell, and nothing else")
    ap.add_argument("--ops", metavar="CELL",
                    help="print the diagnosis view of this cell (ops()), "
                    "and nothing else")
    ap.add_argument("--overrides", default="{}",
                    help="config overrides (JSON) for --ops, e.g. "
                    "'{\"n_layers\": 1, \"unroll_scans\": true}'")
    ap.add_argument("--top", type=int, default=15,
                    help="rows a table of --ops and --temps")
    args = ap.parse_args(argv)
    if args.temps:
        print(temps(args.temps, args.top), end="")
        return {}
    if args.ops:
        print(ops(args.ops, args.top, json.loads(args.overrides)), end="")
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
        before = None
        if args.before:
            with open(args.before) as f:
                before = json.load(f)["port"]
        print(markdown(ref, port, before))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"reference": ref, "port": port, **summary}, f,
                      indent=1)
    return summary


if __name__ == "__main__":
    main()
