"""The span recorder (``repro_torch/core/trace.py``) on the CPU, where the
compiled entries run their plain functions and every phase is a host
span: off it records nothing and changes nothing, on it gives the serve
step's and the MoE block's phases in order under their call, and the
outputs, counters and tiers are the same bit for bit either way. The card
test of the graphs' event-timed phases is in ``tests/test_torch_cuda.py``.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import server as S  # noqa: E402
from repro_torch.core import trace  # noqa: E402
from repro_torch.core.config import (CacheConfig,  # noqa: E402
                                     multi_model_tier_configs)
from repro_torch.core.graph import tensors_of  # noqa: E402
from repro_torch.core.hashing import Key64  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

MIN = 60_000
DIM = 8
B = 16
STEP = ["step.probe", "step.tail", "step.tower", "step.tail", "step.flush"]
KINDS = ["single", "multi"]


@pytest.fixture
def recorder():
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


def _server(kind):
    """A small server (single-model with admission, coalescing and LRU
    touches, or the multi-model tier with admission on some models), a
    fresh-state maker and a linear tower's weights."""
    tower = lambda p, f: f @ p
    if kind == "multi":
        cfgs = [CacheConfig(**{**c.__dict__, "backend": "torch",
                               "infer_budget_per_step":
                               2.5 if m < 3 else None})
                for m, c in enumerate(multi_model_tier_configs(
                    value_dim=DIM, n_buckets=16, ways=4))]
        srv = S.MultiModelServer(cfgs=tuple(cfgs), tower_fn=tower,
                                 miss_budget=12, device="cpu")
        init = lambda: S.init_multi_server_state(cfgs, writebuf_capacity=64,
                                                 device="cpu")
    else:
        cfg = CacheConfig(model_id=1, model_type="ctr", n_buckets=16, ways=4,
                          failover_n_buckets=8, failover_ways=2,
                          value_dim=DIM, cache_ttl_ms=MIN, backend="torch",
                          coalesce_misses=True, infer_budget_per_step=3.5,
                          eviction="lru")
        srv = S.CachedEmbeddingServer(cfg=cfg, tower_fn=tower, miss_budget=12)
        init = lambda: S.init_server_state(cfg, writebuf_capacity=64,
                                           device="cpu")
    w = torch.as_tensor(np.random.default_rng(1).standard_normal((DIM, DIM)),
                        dtype=torch.float32)
    return srv, init, w


def _chunks(kind, n_chunks, steps):
    """The (S, B) inputs after the state of ``n_chunks`` calls."""
    rng = np.random.default_rng(7)
    out = []
    for c in range(n_chunks):
        ids = rng.choice(np.arange(40) * 104729, size=(steps, B))
        args = (Key64.from_int(ids, device="cpu"),
                torch.as_tensor(rng.standard_normal((steps, B, DIM)),
                                dtype=torch.float32),
                torch.as_tensor((np.arange(steps) + c * steps) * 20_000,
                                dtype=torch.int32),
                torch.as_tensor(rng.uniform(size=(steps, B)) < 0.1))
        if kind == "multi":
            args = (torch.as_tensor(rng.integers(0, 8, (steps, B)),
                                    dtype=torch.int32), *args)
        out.append(args)
    return out


def _serve(kind, steps=3):
    """Two ``jit_serve_many`` calls of ``steps`` steps, then one
    ``jit_serve_step`` and one ``jit_flush``: every output, counter and
    the state's tensors after them."""
    srv, init, w = _server(kind)
    state, got = init(), []
    for args in _chunks(kind, 2, steps):
        state, acc, ys = srv.jit_serve_many(w, state, *args)
        got.append((S.fetch_counters(acc), ys))
    args = _chunks(kind, 1, 1)[0]
    lead = (args[0][0],) if kind == "multi" else ()
    keys = args[-4]
    res = srv.jit_serve_step(w, state, *lead, Key64(keys.hi[0], keys.lo[0]),
                             args[-3][0], int(args[-2][0]), args[-1][0])
    state = srv.jit_flush(res.state, int(args[-2][0]))
    got.append((S.fetch_counters(res.stats),
                (res.embeddings, res.source, res.age_ms)))
    return got, tensors_of(state)


@pytest.mark.parametrize("kind", KINDS)
def test_off_records_nothing_and_on_changes_nothing(recorder, kind):
    """Off: no span, phase or counter. On: embeddings, sources, ages,
    counters (per-model vectors too) and every tier plane, ring and budget
    token equal the untraced run's bit for bit."""
    off = _serve(kind)
    drained = recorder.drain()
    assert drained == ([], [])
    recorder.enable()
    on = _serve(kind)
    recorder.disable()
    assert recorder.drain().spans
    for (acc_a, ys_a), (acc_b, ys_b) in zip(off[0], on[0]):
        assert acc_a == acc_b
        for a, b in zip(ys_a, ys_b):
            assert torch.equal(a, b)
    for a, b in zip(off[1], on[1], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_step_phases_in_order_under_their_call(recorder, kind):
    """A traced ``jit_serve_many`` of S steps (a flush each step, then its
    tail flush) gives probe, tail, tower, tail, flush per step, in order,
    each under the call's ``entry`` span with the call's id; the tag
    numbers the call and the next one counts on; every span starts and
    ends between the host clock's reads around the call."""
    srv, init, w = _server(kind)
    steps = 3
    state = init()
    recorder.enable()
    recorder.tag(41)
    for args in _chunks(kind, 2, steps):
        t0 = time.time_ns()
        state, _, _ = srv.jit_serve_many(w, state, *args)
        t1 = time.time_ns()
        spans = recorder.drain().spans
        call = spans[-1].call_id
        assert spans[-1].name == "entry" and spans[-1].parent is None
        inner = [s for s in spans[:-1] if s.name != "trace.read"]
        assert [s.name for s in inner] == STEP * steps + ["step.flush"]
        assert {(s.parent, s.call_id) for s in inner} == {("entry", call)}
        assert [s.start_ns for s in inner] == sorted(
            s.start_ns for s in inner)
        assert all(t0 <= s.start_ns <= s.end_ns <= t1 for s in spans)
    assert call == 42


def test_eager_phases_have_no_call_and_phases_nest(recorder):
    """An eager ``serve_step`` outside a compiled entry records its phases
    with no call and no parent; a phase opened inside another names it as
    its parent, and ending the outer one first raises."""
    srv, init, w = _server("single")
    keys, feats, nows, fails = _chunks("single", 1, 1)[0]
    recorder.enable()
    srv.serve_step(w, init(), Key64(keys.hi[0], keys.lo[0]), feats[0],
                   int(nows[0]), fails[0])
    spans = recorder.drain().spans
    assert [s.name for s in spans] == STEP[:4]
    assert {(s.parent, s.call_id) for s in spans} == {(None, None)}
    cpu = torch.device("cpu")
    recorder.begin("outer", cpu)
    recorder.begin("inner", cpu)
    recorder.end("inner")
    with pytest.raises(RuntimeError, match="inner2"):
        recorder.begin("inner2", cpu)
        recorder.end("outer")
    assert [(s.name, s.parent) for s in recorder.drain().spans] == [
        ("inner", "outer")]


def test_drain_empties_the_recorder(recorder):
    srv, init, w = _server("single")
    recorder.enable()
    srv.jit_serve_many(w, init(), *_chunks("single", 1, 2)[0])
    assert recorder.drain().spans
    assert recorder.drain() == ([], [])


def test_moe_phases_once_per_layer(recorder):
    """A tiny Granite-MoE user tower records ``moe.route`` then
    ``moe.experts`` once a layer, the experts starting after the route
    ends."""
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    model = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    recorder.enable()
    TT.user_tower_step(model, toks, cfg, backend="torch")
    spans = recorder.drain().spans
    assert [s.name for s in spans] == ["moe.route", "moe.experts"] * \
        cfg.n_layers
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
