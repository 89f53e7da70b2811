"""The check that decides ``correct``, driven end to end on the CPU at a
small size with its look for a card skipped: sound runs of both tiny cells
come out correct, and each fault planted under the timed path, and the
lower-precision control, comes out not correct."""
import dataclasses
import time

import pytest
import torch

from bench import harness

DATA = harness.BENCH / "tests" / "data"


def _stale(server):
    """A flush that leaves both tiers as they were."""
    @dataclasses.dataclass(frozen=True)
    class StaleServer(type(server)):
        def flush(self, state, now_ms, enabled=None):
            return state

    return StaleServer(**{f.name: getattr(server, f.name)
                          for f in dataclasses.fields(server)})


def _tower_fault(change):
    def plant(server):
        inner = server.tower_fn

        def tower(p, f):
            out = inner(p, f).clone()
            change(out)
            return out

        return dataclasses.replace(server, tower_fn=tower)

    return plant


def _drop_every_other(out):
    # the tower's rows come misses first, so every other row from the
    # first loses half of the rows that serve a request
    out[0::2] = 0


def _alter(out):
    out[0] = out[1]


FAULTS = {"stale": _stale, "half": _tower_fault(_drop_every_other),
          "alter": _tower_fault(_alter)}


def _run(name, control=False, seed=2 ** 31 + 12345):
    cell = harness.load_cell(name, bench_json=DATA / "bench.json",
                             traffic_dir=DATA / "traffic")
    return harness.run(cell, seed, 0.2, False, device=torch.device("cpu"),
                       t_start=time.perf_counter(), control=control,
                       log=lambda m: None)


@pytest.mark.parametrize("name", ["sasrec.tiny", "granite.tiny"])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-2:] == ["checks", "_lines"]
    assert {"req_per_s", "setup_s"} <= set(out["metrics"])


# a step that leaves the tiers as they were; half of each tower call's
# needed rows lost; one answer replaced by another where the tower makes
# it; and the reference in the program's place one precision below the
# stated one
@pytest.mark.parametrize("fault,number", [
    ("stale", "tier_mismatch"), ("half", "tower_rel_err"),
    ("alter", "tower_rel_err"), ("lowp", "tower_rel_err")])
@pytest.mark.parametrize("name", ["sasrec.tiny", "granite.tiny"])
def test_fault_is_not_correct(name, fault, number, monkeypatch):
    if fault != "lowp":
        inner = harness._server

        def broken(*args, **kw):
            ccfg, server = inner(*args, **kw)
            return ccfg, FAULTS[fault](server)

        monkeypatch.setattr(harness, "_server", broken)
    out = _run(name, control=fault == "lowp")
    assert not out["correct"]
    got = out["checks"][number]
    assert got["value"] > got["limit"]
