"""Guards of the port's boundaries: repro_torch and chip_smoke.py import
neither JAX nor the JAX package, the numpy copies give their originals'
outputs, and nothing meant for the card quietly runs on the CPU."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as j_metrics  # noqa: E402
from repro.data import access_patterns as j_ap  # noqa: E402
from repro.ft import failure as j_failure  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core import server as TS  # noqa: E402
from repro_torch.core.config import (CacheConfig,  # noqa: E402
                                     multi_model_tier_configs)
from repro_torch.core.hashing import Key64  # noqa: E402
from repro_torch.data import access_patterns as t_ap  # noqa: E402
from repro_torch.examples import serve_lm_tower as t_lm_example  # noqa: E402
from repro_torch.ft import failure as t_failure  # noqa: E402
from repro_torch.kernels import cache_probe as tpk  # noqa: E402
from repro_torch.kernels import decode_attention as TDA  # noqa: E402
from repro_torch.launch import serve as t_launch  # noqa: E402
from repro_torch.models import recsys as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists(), path
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


# ------------------------------------------------------------ numpy copies
def test_metrics_copy_matches_original(rng):
    stats = {k: int(v) for k, v in zip(
        ("requests", "direct_hits", "tower_inferences", "tower_failures",
         "overflow", "failover_hits", "fallbacks", "admitted", "deferred",
         "failover_serves", "steps"), rng.integers(0, 1000, 11))}
    want = j_metrics.ServingCounters.from_stats(stats)
    got = t_metrics.ServingCounters.from_stats(stats)
    assert got.as_dict() == want.as_dict()
    got.merge(t_metrics.ServingCounters.from_dict(want.as_dict()))
    want.merge(j_metrics.ServingCounters.from_dict(want.as_dict()))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    xs = list(rng.standard_normal(50))
    assert t_metrics.percentile(xs, 99) == j_metrics.percentile(xs, 99)
    labels = rng.integers(0, 2, 200)
    preds = rng.uniform(size=200)
    assert t_metrics.ne(labels, preds) == j_metrics.ne(labels, preds)
    assert t_metrics.power_savings(0.7, 0.8) == j_metrics.power_savings(
        0.7, 0.8)


@pytest.mark.parametrize("knots", ["FIG2_KNOTS", "FIG6_KNOTS"])
def test_access_patterns_copy_matches_original(knots):
    cfg = dict(n_users=200, horizon_s=2 * 3600.0, thinning=0.8, seed=3)
    jd = j_ap.InterArrivalDist(getattr(j_ap, knots))
    td = t_ap.InterArrivalDist(getattr(t_ap, knots))
    probe = np.array([1.0, 60.0, 600.0, 3600.0])
    np.testing.assert_array_equal(td.cdf(probe), jd.cdf(probe))
    jt, ju = j_ap.generate_stream_fast(j_ap.StreamConfig(**cfg), jd)
    tt, tu = t_ap.generate_stream_fast(t_ap.StreamConfig(**cfg), td)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tu, ju)
    small = dict(cfg, n_users=20)
    for a, b in zip(t_ap.generate_stream(t_ap.StreamConfig(**small), td),
                    j_ap.generate_stream(j_ap.StreamConfig(**small), jd)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_ap.consecutive_interval_cdf(tt, tu, probe),
        j_ap.consecutive_interval_cdf(jt, ju, probe))
    assert (t_ap.simulate_hit_rate(tt, tu, 300_000)
            == j_ap.simulate_hit_rate(jt, ju, 300_000))
    for a, b in zip(t_ap.thin_diurnal(tt, tu, seed=1),
                    j_ap.thin_diurnal(jt, ju, seed=1)):
        np.testing.assert_array_equal(a, b)


def test_failure_copy_matches_original():
    kw = dict(base_rate=0.05, burst_rate=0.5,
              burst_windows_ms=((1000, 5000),), seed=4)
    ji, ti = j_failure.FailureInjector(**kw), t_failure.FailureInjector(**kw)
    for now in (0, 2000, 9000):
        np.testing.assert_array_equal(ti.mask(64, now), ji.mask(64, now))
    steps = list(range(0, 10_000, 500))
    assert ti.kill_steps(steps, 3) == ji.kill_steps(steps, 3)
    assert ti.kill_step(steps, 3) == ji.kill_step(steps, 3)
    for hedge in (None, 25.0):
        a = t_failure.StragglerHedger(hedge_after_ms=hedge,
                                      seed=2).latencies(100)
        b = j_failure.StragglerHedger(hedge_after_ms=hedge,
                                      seed=2).latencies(100)
        np.testing.assert_array_equal(a["latency_ms"], b["latency_ms"])
        assert a["extra_compute_frac"] == b["extra_compute_frac"]


# -------------------------------------------- no quiet fallback to the CPU
def _skip_with_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card is present")


@pytest.mark.parametrize("entry", ["init_cache", "init_server_state",
                                   "init_params", "build_tower",
                                   "run_serving", "key64",
                                   "init_multi_cache",
                                   "init_multi_server_state",
                                   "multi_model_server",
                                   "run_serving_multi", "lm_init_params",
                                   "serve_lm_tower_run", "init_kv_cache",
                                   "decode_attention"])
def test_default_device_entry_points_raise_without_card(entry):
    _skip_with_card()
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=16)
    tier = multi_model_tier_configs(value_dim=8, n_buckets=16)
    calls = {
        "init_cache": lambda: TC.init_cache(16, 4, 8),
        "init_server_state": lambda: TS.init_server_state(cfg),
        "init_params": lambda: TR.init_params(
            torch.Generator(), t_launch.get_config("sasrec", smoke=True)),
        "build_tower": lambda: t_launch.build_tower("sasrec"),
        "run_serving": lambda: t_launch.run_serving(minutes=1, users=10),
        "key64": lambda: Key64.from_int(np.arange(4)),
        "init_multi_cache": lambda: TC.init_multi_cache([16, 32], 4, 8),
        "init_multi_server_state": lambda: TS.init_multi_server_state(tier),
        "multi_model_server": lambda: TS.MultiModelServer(
            cfgs=tuple(tier), tower_fn=lambda p, f: f["x"], miss_budget=4),
        "run_serving_multi": lambda: t_launch.run_serving_multi(
            minutes=1, users=10),
        "lm_init_params": lambda: TT.init_params(
            torch.Generator(), t_launch.get_config("tinyllama-1.1b",
                                                   smoke=True)),
        "serve_lm_tower_run": lambda: t_lm_example.run(minutes=1, users=10),
        "init_kv_cache": lambda: TT.init_kv_cache(
            t_launch.get_config("tinyllama-1.1b", smoke=True), 2, 16),
        "decode_attention": lambda: TDA.decode_attention(
            torch.zeros((1, 4, 8), device="cuda"),
            torch.zeros((1, 16, 2, 8), device="cuda"),
            torch.zeros((1, 16, 2, 8), device="cuda")),
    }
    with pytest.raises((RuntimeError, AssertionError)):
        calls[entry]()


def test_cuda_backend_with_cpu_tensors_raises(rng):
    """backend/impl 'cuda' never runs the plain version on CPU tensors:
    lookups, the serve step and the tower's bag raise, and nothing is
    counted as a launch."""
    st = TC.init_cache(16, 4, 8, device="cpu")
    keys = Key64.from_int(np.arange(5), device="cpu")
    n0 = dict(tpk.LAUNCHES)
    with pytest.raises(ValueError):
        TC.lookup(st, keys, 0, 1000, backend="cuda")
    with pytest.raises(ValueError):
        TC.lookup_dual(st, st, keys, 0, 1000, 1000, backend="cuda")
    cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=16,
                      value_dim=8)                 # backend defaults to cuda
    srv = TS.CachedEmbeddingServer(cfg=cfg, tower_fn=lambda p, f: f["x"],
                                   miss_budget=4)
    state = TS.init_server_state(cfg, device="cpu")
    with pytest.raises(ValueError):
        srv.serve_step(None, state, keys, {"x": torch.zeros(5, 8)}, 0)
    with pytest.raises(ValueError):
        TR.embedding_bag(torch.zeros(10, 4), torch.zeros(3, 1,
                                                         dtype=torch.int32),
                         impl="cuda")
    # the multi-model tier: probe and serve step
    tier = tuple(multi_model_tier_configs(value_dim=8, n_buckets=16))
    policy = TC.policy_from_configs(tier, device="cpu")
    mstate = TS.init_multi_server_state(tier, device="cpu")
    slots = torch.arange(5, dtype=torch.int32) % 8
    with pytest.raises(ValueError):
        TC.lookup_dual_multi(mstate.direct, mstate.failover, policy, slots,
                             keys, 0, backend="cuda")
    msrv = TS.MultiModelServer(cfgs=tier, tower_fn=lambda p, f: f["x"],
                               miss_budget=4, device="cpu")
    assert msrv.backend == "cuda"             # the configs' default
    with pytest.raises(ValueError):
        msrv.serve_step(None, mstate, slots, keys, {"x": torch.zeros(5, 8)},
                        0)
    assert tpk.LAUNCHES == n0
    # the LM tower: backend "cuda" never takes the plain attention on the
    # CPU
    lm_cfg = t_launch.get_config("tinyllama-1.1b", smoke=True)
    lm = TT.init_params(torch.Generator(), lm_cfg, device="cpu")
    with pytest.raises(ValueError):
        TT.user_tower_step(lm, torch.zeros((2, 8), dtype=torch.int32),
                           lm_cfg, backend="cuda")
    # the LM's generation path: prefill and decode steps
    cache = TT.init_kv_cache(lm_cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError):
        TT.prefill_step(lm, torch.zeros((2, 8), dtype=torch.int32), lm_cfg,
                        backend="cuda")
    with pytest.raises(ValueError):
        TT.decode_step(lm, cache, torch.zeros(2, dtype=torch.int32), lm_cfg,
                       backend="cuda")
    assert TDA.LAUNCHES["decode_attention"] == 0


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        CacheConfig(model_id=1, model_type="ctr", backend="jnp")
    st = TC.init_cache(16, 4, 8, device="cpu")
    with pytest.raises(ValueError):
        TC.lookup(st, Key64.from_int(np.arange(2), device="cpu"), 0, 1,
                  backend="pallas")
