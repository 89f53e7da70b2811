"""The comparison that decides ``correct``: the plain reference replays
every batch the program served, from the same image, stream, failures and
weights, and judges what the program answered and left behind.

Numbers compared, each against its limit:

* ``serve_mismatch`` (exact, 0): rows whose source or age differs from the
  reference's, batches whose counters differ (direct hits, failover hits
  and serves, tower inferences and failures, overflow, fallbacks), and, in
  the sampled batches, rows whose value should be a copy (an image entry's
  value, or the default embedding of a fallback) and is not exactly that;
* ``tier_mismatch`` (exact, 0): cells of the key, write-time and recency
  planes of both tiers that differ from the reference's after the last
  flush, and image entries among the sampled slots whose value moved;
* ``tower_rel_err``: the worst relative L2 gap, over sampled answers and
  sampled slots that a tower run wrote, between the program's embedding
  and the reference tower's float32 forward of the same user's features
  at the entry's write time (``now - age``).

On a card the reference's batch step is captured once as a CUDA graph and
replayed batch after batch (plain ops, one shape a batch); elsewhere it
runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from bench.reference import ercache as ref_tier
from bench.reference.precision import matmul_at
from bench.stream import mix64


@dataclasses.dataclass
class Served:
    """What the program produced over every batch it served."""

    n_batches: int
    source: np.ndarray            # (n, B) int32
    age: np.ndarray               # (n, B) int32
    counters: Dict[str, np.ndarray]
    emb: Dict[int, np.ndarray]    # sampled batch -> (B, D) float32
    direct: object                # the program's final tables
    failover: object


@dataclasses.dataclass
class Report:
    numbers: Dict[str, float]
    limits: Dict[str, float]
    bad_rows: np.ndarray          # (n,) rows judged wrong, per batch
    hits_d: np.ndarray            # (n,) direct-tier probe hits
    hits_f: np.ndarray            # (n,) failover-tier probe hits
    selected: torch.Tensor        # (n, B) bool, the tower's rows

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in self.numbers)

    def lines(self) -> List[str]:
        return [f"check {k}: {self.numbers[k]!r} (limit {self.limits[k]!r})"
                for k in self.numbers]


def sampled(seed: int, i: int, every: int) -> bool:
    h = mix64(np.asarray([seed & (2 ** 64 - 1)], np.uint64)
              ^ mix64(np.asarray([i], np.uint64)))[0]
    return int(h % np.uint64(every)) == 0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    got, want = got.double(), want.double()
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp(min=1e-30)


class _Replay:
    """The reference's serve and flush of batch ``i`` (a (1,) device index
    the caller sets), every output written into row i of (n, ...)
    tensors: one shape, so a CUDA graph can hold it."""

    def __init__(self, cell, stream, served: Served, tiers, device):
        tr, c = cell.traffic, cell.cfg["cache"]
        n, B = served.n_batches, tr.batch
        uid = stream.uid[:n * B]
        hi, lo = ref_tier.key_words(uid)
        dev = lambda a: torch.as_tensor(a, device=device).view(n, -1)
        self.hi, self.lo = dev(hi), dev(lo)
        self.bd, self.bf = (dev(b) for b in ref_tier.bucket_of(
            uid, c["n_buckets"], c["failover_n_buckets"]))
        self.fail = dev(stream.fail[:n * B])
        self.now = torch.as_tensor([stream.batch_now(i) for i in range(n)],
                                   dtype=torch.int64, device=device)
        self.p_src = dev(served.source)
        self.p_age = dev(served.age)
        self.tiers = tiers
        self.args = (cell.miss_budget, c["cache_ttl_ms"], c["failover_ttl_ms"])
        self.i = torch.zeros(1, dtype=torch.int64, device=device)
        z = lambda *s, dt=torch.int64: torch.zeros(s, dtype=dt, device=device)
        self.bad, self.cnt, self.hits = z(n), z(n, 6), z(n, 2)
        self.src, self.age = z(n, B, dt=torch.int32), z(n, B, dt=torch.int32)
        self.od, self.of = z(n, B, dt=torch.int32), z(n, B, dt=torch.int32)
        self.sel = z(n, B, dt=torch.bool)

    def step(self) -> None:
        row = lambda t: t.index_select(0, self.i)[0]
        mb, ttl_d, ttl_f = self.args
        direct, failover = self.tiers
        now = row(self.now)
        bd, bf, hi, lo = row(self.bd), row(self.bf), row(self.hi), row(self.lo)
        s = ref_tier.serve(direct, failover, bd, bf, hi, lo, now,
                           row(self.fail), mb, ttl_d, ttl_f)
        bad = ((s.source != row(self.p_src)) | (s.age != row(self.p_age))).sum()
        ref_tier.flush((direct, failover), (bd, bf), hi, lo, now, now,
                       (ttl_d, ttl_f), ref_tier.FROM_TOWER, live=s.computed)
        hits = torch.stack([s.direct.hit.sum(), s.failover.hit.sum()])
        for out, v in ((self.bad, bad), (self.cnt, s.counters),
                       (self.hits, hits), (self.src, s.source),
                       (self.age, s.age), (self.od, s.direct.origin),
                       (self.of, s.failover.origin), (self.sel, s.selected)):
            out.index_copy_(0, self.i, v[None])

    def run(self, n: int) -> None:
        self.i.fill_(0)
        self.step()
        if not self.i.is_cuda or n == 1:
            for i in range(1, n):
                self.i.fill_(i)
                self.step()
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
        for i in range(1, n):
            self.i.fill_(i)
            graph.replay()
        torch.cuda.synchronize()
        del graph


def reference_pass(cell, fam, weights, stream, feats, tiers0, image_values,
                   served: Served, seed: int, device="cuda") -> Report:
    B, n = cell.traffic.batch, served.n_batches
    direct, failover = (t.clone() for t in tiers0)
    rp = _Replay(cell, stream, served, (direct, failover), device)
    rp.run(n)
    bad_rows = rp.bad.cpu().numpy()
    serve_bad = int(bad_rows.sum())
    cnt = rp.cnt.cpu().numpy()
    for j, k in enumerate(ref_tier.COUNTER_KEYS):
        serve_bad += int((served.counters[k][:n] != cnt[:, j]).sum())
    fo = ref_tier.COUNTER_KEYS.index("failover_hits")
    serve_bad += int((served.counters["failover_serves"][:n]
                      != cnt[:, fo]).sum())
    hits = rp.hits.cpu().numpy()

    # values of the sampled answers, by provenance
    uid = stream.uid[:n * B]
    tower_rows = []                  # (batch, row, uid, write ts)
    for i in sorted(served.emb):
        src, age = rp.src[i].cpu().numpy(), rp.age[i].cpu().numpy()
        od, of = rp.od[i].cpu().numpy(), rp.of[i].cpu().numpy()
        now = stream.batch_now(i)
        got = served.emb[i]
        u = uid[i * B:(i + 1) * B]
        origin = np.where(src == ref_tier.SRC_DIRECT, od,
                          np.where(src == ref_tier.SRC_FAILOVER, of,
                                   ref_tier.FROM_TOWER))
        fb = src == ref_tier.SRC_FALLBACK
        wrong = fb & np.any(got != 0.0, axis=1)
        img = ~fb & (origin == ref_tier.FROM_IMAGE)
        if img.any():
            want = image_values[torch.as_tensor(u[img], device=device)]
            wrong[img] |= np.any(got[img] != want.cpu().numpy(), axis=1)
        serve_bad += int(wrong.sum())
        bad_rows[i] += int(wrong.sum())
        for r in np.nonzero(~fb & (origin == ref_tier.FROM_TOWER))[0]:
            tower_rows.append((i, r, u[r], now - age[r]))

    # what the flushes left: planes, sampled image and tower slots
    tier_bad = 0
    slot_rows = []                   # (value, uid, write ts)
    rng = np.random.default_rng([seed & (2 ** 63 - 1), 17])
    chk = cell.cfg["check"]
    for mine, theirs in ((direct, served.direct), (failover, served.failover)):
        for a, b in ((mine.key_hi, theirs.key_hi), (mine.key_lo, theirs.key_lo),
                     (mine.ts, theirs.write_ts),
                     (mine.ts, theirs.last_access_ts)):
            tier_bad += int((a != b).sum())
        for origin, k in ((ref_tier.FROM_IMAGE, chk["image_slots"]),
                          (ref_tier.FROM_TOWER, chk["tower_slots"])):
            where = torch.nonzero(mine.origin == origin)
            if len(where) > k:
                where = where[torch.as_tensor(
                    rng.choice(len(where), k, replace=False), device=device)]
            b, w = where[:, 0], where[:, 1]
            u = ((mine.key_hi[b, w].long() << 32)
                 | (mine.key_lo[b, w].long() & 0xFFFFFFFF))
            if origin == ref_tier.FROM_IMAGE:
                want = image_values[u].to(theirs.values.dtype)
                tier_bad += int((theirs.values[b, w] != want).any(dim=1).sum())
            else:
                slot_rows += list(zip(theirs.values[b, w].cpu().numpy(),
                                      u.cpu().numpy(),
                                      mine.ts[b, w].cpu().numpy()))

    # the tower, against the float32 reference
    if len(tower_rows) > chk["tower_rows"]:
        pick = rng.choice(len(tower_rows), chk["tower_rows"], replace=False)
        tower_rows = [tower_rows[j] for j in sorted(pick)]
    got = [served.emb[i][r] for i, r, _, _ in tower_rows]
    got += [v for v, _, _ in slot_rows]
    users = torch.as_tensor([x[2] for x in tower_rows]
                            + [x[1] for x in slot_rows], dtype=torch.int64,
                            device=device)
    times = torch.as_tensor([x[3] for x in tower_rows]
                            + [x[2] for x in slot_rows], dtype=torch.int64,
                            device=device)
    errs = torch.zeros(0, dtype=torch.float64)
    if len(users):
        mm = matmul_at("float32")
        step = chk["reference_rows"]
        with torch.no_grad():
            want = torch.cat([
                fam.reference(weights, feats.of(users[j:j + step],
                                                times[j:j + step]), mm,
                              cell.miss_budget).cpu()
                for j in range(0, len(users), step)])
        errs = rel_err(torch.as_tensor(np.stack(got)), want)
        row_bad = (errs > cell.cfg["limits"]["tower_rel_err"]).numpy()
        for j, (i, *_rest) in enumerate(tower_rows):
            bad_rows[i] += int(row_bad[j])
    numbers = {"serve_mismatch": serve_bad, "tier_mismatch": tier_bad,
               "tower_rel_err": float(errs.max()) if len(errs) else 0.0}
    limits = {"serve_mismatch": 0, "tier_mismatch": 0,
              "tower_rel_err": cell.cfg["limits"]["tower_rel_err"]}
    return Report(numbers, limits, bad_rows, hits[:, 0], hits[:, 1], rp.sel)
