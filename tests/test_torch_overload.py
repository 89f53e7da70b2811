"""repro_torch's overload arm and quickstart against the JAX package, on
the CPU: ``run_serving_overload`` phase by phase, the flash crowd's
``_stage_chunk(override_ids=...)``, the CLI's refusals, and the
quickstart's printed lines.

Counters, the budget and the provisioned miss rate must match exactly;
``mean_failover_stale_ms`` within 0.1 ms, because both reports round it to
0.1 ms from float32 sums that may round in another order.
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as j_launch  # noqa: E402
from repro_torch.core.metrics import ServingCounters  # noqa: E402
from repro_torch.data.access_patterns import (FIG6_KNOTS,  # noqa: E402
                                              InterArrivalDist, StreamConfig,
                                              generate_stream_fast)
from repro_torch.examples import quickstart as t_quickstart  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STALE_ATOL_MS = 0.1


@pytest.mark.parametrize("failures", [
    dict(failure_rate=0.05, failure_burst_rate=0.3), dict()],
    ids=["failure-burst", "no-failures"])
def test_run_serving_overload_matches_jax(failures):
    """The overload timeline end to end (SMOKE SASRec): the budget, the
    provisioned miss rate and every per-phase counter equal the JAX
    launcher's on the same stream (the towers' random weights differ, and
    no counter depends on them)."""
    common = dict(arch="sasrec", minutes=12, users=300, batch=64,
                  chunk_steps=4, log=lambda *_: None, **failures)
    want = j_launch.run_serving_overload(backend="jnp", **common)
    got = t_launch.run_serving_overload(backend="torch", device="cpu",
                                        **common)
    for k in ("budget_per_step", "provisioned_miss_rate", "budget_frac",
              "failure_rate", "failure_burst_rate"):
        assert got[k] == want[k], k
    assert list(got["phases"]) == ["pre", "outage", "post"]
    for p, w in want["phases"].items():
        g = got["phases"][p]
        for f in dataclasses.fields(ServingCounters):
            assert g[f.name] == w[f.name], (p, f.name)
        assert g["fallback_rate_wo_failover"] == w[
            "fallback_rate_wo_failover"], p
        assert abs(g["mean_failover_stale_ms"]
                   - w["mean_failover_stale_ms"]) <= STALE_ATOL_MS, p
    outage = got["phases"]["outage"]
    assert outage["deferred"] > 0
    assert got["phases"]["pre"]["deferred"] == 0
    if failures:   # the burst reaches the relaxed failover tier
        assert outage["failover_serves"] > 0
        assert outage["mean_failover_stale_ms"] > 0


def test_stage_chunk_override_ids_keep_the_clock():
    """The flash crowd's staging: the override ids with the stream's
    clock, as the JAX ``_stage_chunk`` stages them."""
    times, uids = generate_stream_fast(
        StreamConfig(n_users=50, horizon_s=120.0, seed=0),
        InterArrivalDist(FIG6_KNOTS))
    batch, n_steps, lo = 8, 3, 16
    override = np.random.default_rng(1).integers(0, 50, (n_steps, batch))

    def features_of(ids, now):
        return {"seq": (np.asarray(ids, np.int32)[:, None] + now % 7)}

    want = j_launch._stage_chunk(uids, times, features_of, lo, n_steps,
                                 batch, override_ids=override)
    got = t_launch._stage_chunk(uids, times, features_of, lo, n_steps, batch,
                                "cpu", override_ids=override)
    for g, w in ((got[0].hi, want[0].hi), (got[0].lo, want[0].lo),
                 (got[1]["seq"], want[1]["seq"]), (got[2], want[2])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids = (got[0].hi.long() << 32) | (got[0].lo.long() & 0xFFFFFFFF)
    np.testing.assert_array_equal(ids.numpy(), override)
    np.testing.assert_array_equal(
        got[2].numpy(), times[lo + batch * np.arange(1, n_steps + 1) - 1])


@pytest.mark.parametrize("flags", [["--multi"], ["--no-cache"],
                                   ["--coalesce"], ["--eviction", "lru"]])
def test_overload_cli_refuses_what_the_reference_refuses(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        t_launch.main(["--overload", *flags])
    assert exc.value.code == 2
    assert "--overload" in capsys.readouterr().err


def test_quickstart_prints_the_reference_lines():
    spec = importlib.util.spec_from_file_location(
        "reference_quickstart", ROOT / "examples" / "quickstart.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    outs = []
    for run in (ref.main,
                lambda: t_quickstart.main(device="cpu", backend="torch")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        outs.append(buf.getvalue().splitlines())
    assert len(outs[0]) == 5
    assert outs[1] == outs[0]
