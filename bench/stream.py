"""Traffic: the request stream, each user's features, and the set-up
image of both tiers, all made from ``--seed``.

One general generator reads a traffic file (``bench/traffic/<mix>.json``):

* users: independent renewal processes whose gaps follow a piecewise
  log-linear CDF (``interarrival_knots``, seconds; the Fig. 6 knots of
  ``repro_torch.data.access_patterns``), each started in equilibrium (its
  first arrival a uniform fraction of a length-biased gap), so the merged
  stream is stationary from time 0. Drawn on the device in a few large
  calls;
* the first ``prefix_s`` seconds are not served: they decide the image, the
  entries a server that computed every miss would have left (each user's
  last write before the served part starts);
* the served part: consecutive batches of ``batch`` requests, a batch's
  clock the time of its last request, each request failing its tower run
  with probability ``failure_rate``;
* features: a history of ``history_len`` item or token ids a user (ids
  uniform over the vocabulary, a uniform length of ``min_history`` up to
  ``history_len`` with the earlier positions padded -1 where
  ``min_history`` is below ``history_len``), whose last
  ``session_len`` ids change every ``session_ms``: a hash of (seed, user,
  position, clock), so a recomputed embedding differs from a stale one and
  no table grows with the population;
* the image: each user's last write in the prefix, inserted into both
  tiers with the reference's plain insert in write-time order, so a
  population whose prefix writes more keys than a tier holds leaves it
  full, its evictions decided as a running server's would be; each image
  entry's value a hash of (seed, user).

Sizes: the stream holds ``max_req_per_s`` x the run's seconds requests
besides the set-up's batches; a run that needs more fails.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bench.reference import ercache as ref_tier

# gaps drawn at once for each user still short of the stream's end
GAP_COLUMNS = 32
# users drawn together: bounds the draw's temporaries
USER_CHUNK = 1 << 22
# an image flush writes one record per this many buckets of the smaller
# tier, so that two records rarely meet in one bucket of one flush
IMAGE_SPREAD = 16


def mix64(x):
    """splitmix64's finaliser on uint64 (numpy), or on int64 tensors with
    wrapping products and arithmetic shifts (a different, equally fixed
    mix)."""
    if isinstance(x, torch.Tensor):
        x = (x ^ (x >> 30)) * _C1
        x = (x ^ (x >> 27)) * _C2
        return x ^ (x >> 31)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


_C1, _C2 = _signed(0xBF58476D1CE4E5B9), _signed(0x94D049BB133111EB)
_C3, _C4 = _signed(0x9E3779B97F4A7C15), _signed(0xD6E8FEB86659FD93)


@dataclasses.dataclass
class Traffic:
    name: str
    users: int
    batch: int
    failure_rate: float
    interarrival_knots: list
    prefix_s: float
    max_req_per_s: float
    history_len: int
    min_history: int
    session_len: int
    session_ms: int
    warmup_batches: int
    trace_batches: int
    arrivals: str = "closed_loop"
    clients: int = 1
    why: str = ""

    @staticmethod
    def from_json(d: dict) -> "Traffic":
        fields = {f.name for f in dataclasses.fields(Traffic)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        t = Traffic(**d)
        if t.arrivals != "closed_loop" or t.clients != 1:
            raise ValueError("the generator drives one closed-loop client")
        return t


def _knots(tr: Traffic, device):
    k = torch.tensor(tr.interarrival_knots, dtype=torch.float64,
                     device=device)
    return k[:, 0].contiguous(), k[:, 1].contiguous()


def mean_gap_s(tr: Traffic) -> float:
    t = np.array([k[0] for k in tr.interarrival_knots])
    f = np.array([k[1] for k in tr.interarrival_knots])
    return float((np.diff(f) / np.diff(np.log(t)) * np.diff(t)).sum())


def _gaps(gen, n_rows: int, n_cols: int, t, f):
    """Inverse-CDF draws of the gaps (seconds): the CDF is linear in log t
    between knots."""
    u = torch.rand((n_rows, n_cols), generator=gen, device=t.device,
                   dtype=torch.float64) * (1 - f[0]) + f[0]
    seg = (torch.searchsorted(f, u, right=True) - 1).clamp(0, len(f) - 2)
    x0, x1 = torch.log(t)[seg], torch.log(t)[seg + 1]
    f0, f1 = f[seg], f[seg + 1]
    return torch.exp(x0 + (u - f0) / (f1 - f0) * (x1 - x0))


def _first_arrivals(gen, n: int, t, f):
    """Forward recurrence times: a length-biased gap (uniform in t within
    a knot segment picked by its share of the mean) times a uniform."""
    x = torch.log(t)
    mass = (f[1:] - f[:-1]) / (x[1:] - x[:-1]) * (t[1:] - t[:-1])
    seg = torch.multinomial(mass / mass.sum(), n, replacement=True,
                            generator=gen)
    u = torch.rand(n, generator=gen, device=t.device, dtype=torch.float64)
    length = t[seg] + u * (t[seg + 1] - t[seg])
    return torch.rand(n, generator=gen, device=t.device,
                      dtype=torch.float64) * length


@dataclasses.dataclass
class Stream:
    uid: np.ndarray         # (N,) int64, served requests in order
    t_ms: np.ndarray        # (N,) int32, stream clock
    fail: np.ndarray        # (N,) bool
    batch: int
    image_uid: torch.Tensor  # (M,) int64 users the image holds
    image_ts: torch.Tensor   # (M,) int64 their last write

    @property
    def n_batches(self) -> int:
        return self.uid.shape[0] // self.batch

    def batch_now(self, i: int) -> int:
        return int(self.t_ms[(i + 1) * self.batch - 1])


def make_stream(tr: Traffic, seed: int, seconds: float, ttl_direct_ms: int,
                device) -> Stream:
    """The served stream and the users the image holds (module
    docstring). Users are drawn ``USER_CHUNK`` at a time, and each block of
    ``GAP_COLUMNS`` gaps only for the users whose last arrival is still
    before the stream's end."""
    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    t, f = _knots(tr, device)
    need = int(math.ceil((tr.max_req_per_s * seconds) / tr.batch)
               + tr.warmup_batches) * tr.batch
    rate = tr.users / mean_gap_s(tr)
    t0 = tr.prefix_s
    t_end = t0 + 1.3 * need / rate + 1.0
    ttl = ttl_direct_ms / 1e3
    img_u, img_t, srv_u, srv_t = [], [], [], []
    for lo in range(0, tr.users, USER_CHUNK):
        n = min(USER_CHUNK, tr.users - lo)
        idx = torch.arange(n, device=device)
        block = _first_arrivals(gen, n, t, f)[:, None]
        # each user's last write in the prefix: every miss written
        lw = torch.full((n,), -math.inf, dtype=torch.float64, device=device)
        while True:
            lw_a = lw[idx]
            for k in range(block.shape[1]):
                tk = block[:, k]
                lw_a = torch.where((tk < t0) & (tk - lw_a > ttl), tk, lw_a)
            lw[idx] = lw_a
            served = (block >= t0) & (block < t_end)
            srv_t.append(block[served])
            srv_u.append((idx + lo).repeat_interleave(served.sum(dim=1)))
            last = block[:, -1]
            more = last < t_end
            if not bool(more.any()):
                break
            idx, last = idx[more], last[more]
            block = last[:, None] + torch.cumsum(
                _gaps(gen, idx.numel(), GAP_COLUMNS, t, f), dim=1)
        have = torch.isfinite(lw)
        img_u.append(torch.nonzero(have).flatten() + lo)
        img_t.append(torch.floor(lw[have] * 1e3).long())
        del lw, block
    flat_t, flat_u = torch.cat(srv_t), torch.cat(srv_u)
    del srv_t, srv_u
    if flat_t.numel() < need:
        raise RuntimeError(f"the stream drew {flat_t.numel()} requests, "
                           f"fewer than the {need} it must hold")
    order = torch.sort(flat_t, stable=True).indices[:need]
    t_ms = torch.floor(flat_t[order] * 1e3).to(torch.int32)
    uid = flat_u[order]
    del flat_t, flat_u, order
    fail = torch.rand(need, generator=gen, device=device) < tr.failure_rate
    return Stream(uid=uid.cpu().numpy(), t_ms=t_ms.cpu().numpy(),
                  fail=fail.cpu().numpy(), batch=tr.batch,
                  image_uid=torch.cat(img_u), image_ts=torch.cat(img_t))


def _hash_rows(uid: torch.Tensor, salt: int, width: int) -> torch.Tensor:
    """(R, width) int64 hashes of (salt, user, column)."""
    base = mix64(mix64(uid * _C3) ^ salt)
    col = torch.arange(width, device=uid.device)
    return mix64(base[:, None] + col[None, :] * _C4)


class Features:
    """Each user's history, a hash of (seed, user, position), and its
    session part, a hash of (seed, user, clock): ``of`` runs on the
    device, for the staged stream and for the reference alike."""

    def __init__(self, tr: Traffic, vocab: int, seed: int, device):
        self.width = tr.history_len
        self.min_history = tr.min_history
        self.vocab = vocab
        self.session_len = tr.session_len
        self.session_ms = tr.session_ms
        self.salt = _signed(seed & (2 ** 64 - 1))
        self.device = device

    def of(self, uid: torch.Tensor, now_ms: torch.Tensor) -> torch.Tensor:
        """(R, history_len) int32 ids of users ``uid`` (R,) at clocks
        ``now_ms`` (R,), both int64 on the device."""
        S = self.width
        h = _hash_rows(uid, self.salt ^ 0x5DEECE66D, S + 1)
        out = (h[:, :S] % self.vocab).to(torch.int32)
        if self.min_history < S:
            length = self.min_history + h[:, S] % (S - self.min_history + 1)
            pad = torch.arange(S, device=uid.device)[None, :] < \
                S - length[:, None]
            out = torch.where(pad, -1, out)
        del h
        n = self.session_len
        if n:
            epoch = now_ms // self.session_ms
            base = mix64(mix64(uid * _C3 + epoch) ^ self.salt)
            pos = torch.arange(n, device=uid.device)
            h = mix64(base[:, None] + pos[None, :] * _C4)
            session = (h % self.vocab).to(torch.int32)
            tail = out[:, -n:]
            out[:, -n:] = torch.where(tail >= 0, session, tail)
        return out


class ImageValues:
    """Each image entry's value: ``values[uid]`` is (R, dim) float32,
    uniform in [-1, 1), a hash of (seed, user, dimension)."""

    def __init__(self, dim: int, seed: int):
        self.dim = dim
        self.salt = _signed((seed ^ 0x2545F4914F6CDD1D) & (2 ** 64 - 1))

    def __getitem__(self, uid: torch.Tensor) -> torch.Tensor:
        # the torch mix leaves its hashes non-negative: 24 bits from the top
        h = _hash_rows(uid.long(), self.salt, self.dim)
        return (h >> 39).to(torch.float32) * 2.0 ** -23 - 1.0


def image_tiers(stream: Stream, n_buckets: int, ways: int, fo_buckets: int,
                fo_ways: int, ttl_d: int, ttl_f: int, device):
    """Both tiers' image, written with the reference's plain insert in
    write-time order, a flush of one record per ``IMAGE_SPREAD`` buckets at
    a time at the clock of its last record: returns (direct, failover)
    reference tiers whose entries are all ``FROM_IMAGE``."""
    order = torch.sort(stream.image_ts, stable=True).indices
    ts = stream.image_ts[order]
    uid = stream.image_uid[order].cpu().numpy()
    hi, lo = (torch.as_tensor(w, device=device)
              for w in ref_tier.key_words(uid))
    bd, bf = (torch.as_tensor(b, device=device)
              for b in ref_tier.bucket_of(uid, n_buckets, fo_buckets))
    tiers = (ref_tier.Tier.empty(n_buckets, ways, device),
             ref_tier.Tier.empty(fo_buckets, fo_ways, device))
    step = max(1, min(n_buckets, fo_buckets) // IMAGE_SPREAD)
    for a in range(0, len(uid), step):
        c = slice(a, a + step)
        ref_tier.flush(tiers, (bd[c], bf[c]), hi[c], lo[c], ts[c],
                       int(ts[c][-1]), (ttl_d, ttl_f), ref_tier.FROM_IMAGE)
    return tiers
