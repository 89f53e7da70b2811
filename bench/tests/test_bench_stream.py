"""The traffic generator: the same seed gives the same stream, image and
features; a population whose prefix writes more keys than a tier holds
leaves the tier full, newer entries kept before older ones."""
import json

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import ercache as ref_tier
from bench.stream import (Features, ImageValues, Traffic, image_tiers,
                          make_stream)

TRAFFIC = harness.BENCH / "tests" / "data" / "traffic" / "tiny.seq.json"
CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


def _traffic(**kw):
    d = json.loads(TRAFFIC.read_text())
    d.update(kw)
    return Traffic.from_json(d)


def test_same_seed_same_stream_and_image():
    tr = _traffic()
    a, b = (make_stream(tr, SEED, 0.05, 300000, CPU) for _ in range(2))
    assert np.array_equal(a.uid, b.uid) and np.array_equal(a.t_ms, b.t_ms)
    assert np.array_equal(a.fail, b.fail)
    assert torch.equal(a.image_uid, b.image_uid)
    assert torch.equal(a.image_ts, b.image_ts)
    assert (np.diff(a.t_ms) >= 0).all()
    c = make_stream(tr, SEED + 1, 0.05, 300000, CPU)
    assert not np.array_equal(a.uid[:100], c.uid[:100])


def test_user_chunks_do_not_change_what_a_chunk_draws(monkeypatch):
    """Users drawn in several chunks: every request and image entry is one
    of the population's, in clock order."""
    import bench.stream as st

    monkeypatch.setattr(st, "USER_CHUNK", 256)
    tr = _traffic()
    s = make_stream(tr, SEED, 0.05, 300000, CPU)
    assert s.uid.min() >= 0 and s.uid.max() < tr.users
    assert len(np.unique(s.uid)) > 256
    assert int(s.image_uid.max()) >= 256
    assert (np.diff(s.t_ms) >= 0).all()


@pytest.mark.parametrize("nb,ways", [(16, 4), (32, 2)])
def test_image_of_a_large_population_fills_the_tier(nb, ways):
    tr = _traffic(users=2000)
    s = make_stream(tr, SEED, 0.05, 300000, CPU)
    assert len(s.image_uid) > 4 * nb * ways
    direct, fo = image_tiers(s, nb, ways, nb, ways, 300000, 3600000, CPU)
    for t in (direct, fo):
        assert bool((t.origin == ref_tier.FROM_IMAGE).all())
    kept = direct.ts.flatten().double()
    assert kept.mean() > s.image_ts.double().mean()


def test_features_and_image_values_are_functions_of_their_inputs():
    tr = _traffic()
    f = Features(tr, 512, SEED, CPU)
    uid = torch.arange(300)
    now = torch.full_like(uid, 10 * 60000)
    a = f.of(uid, now)
    assert torch.equal(a, Features(tr, 512, SEED, CPU).of(uid, now))
    assert a.shape == (300, tr.history_len)
    assert int(a.max()) < 512 and int(a.min()) >= -1
    pads = (a < 0).sum(dim=1)
    assert int(pads.max()) == tr.history_len - tr.min_history
    assert int(pads.min()) == 0
    later = f.of(uid, now + tr.session_ms)
    assert torch.equal(a[:, :-tr.session_len], later[:, :-tr.session_len])
    assert not torch.equal(a[:, -1], later[:, -1])
    v = ImageValues(16, SEED)
    x = v[uid]
    assert x.dtype == torch.float32 and x.shape == (300, 16)
    assert torch.equal(x, ImageValues(16, SEED)[uid])
    assert float(x.abs().max()) <= 1.0 and abs(float(x.mean())) < 0.05
