"""The yardstick: the chip's peaks, and the least bytes and operations each
measured kernel and tower row needs, counted from shapes and hits once, so
that the count does not change with whatever implements the kernel."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,     # outside the tensor cores
}


def probe_bytes(B: int, hits_d: int, hits_f: int, ways_d: int, ways_f: int,
                dim: int, elem: int) -> int:
    """A dual probe of B queries: each query's key words and two bucket
    ids read (16 B), 3 int32 words of each way in both buckets (key hi,
    key lo, write time), the winning row only on a hit; written per table
    and query: hit (1 B), age and way (4 B each) and the value row."""
    reads = B * 16 + B * 12 * (ways_d + ways_f) + (hits_d + hits_f) * dim * elem
    writes = 2 * B * (1 + 4 + 4 + dim * elem)
    return reads + writes


def bag_bytes(n_bags: int, n_ids: int, n_rows: int, dim: int,
              elem: int) -> int:
    """An embedding bag: every id read (4 B), each row an id names read
    once per bag (``n_rows``: the ids that are not padding), each bag's
    output row written."""
    return n_ids * 4 + n_rows * dim * elem + n_bags * dim * elem


def flash_work(batch: int, seq: int, q_heads: int, kv_heads: int,
               head_dim: int, elem: int, causal: bool = True):
    """(operations, bytes) of one attention launch over ``batch`` rows:
    two products over the (causal) score entries, 2 operations a
    multiply-add; q, k, v read and the output written once."""
    pairs = seq * (seq + 1) // 2 if causal else seq * seq
    ops = 4 * batch * q_heads * head_dim * pairs
    io = batch * seq * head_dim * elem * (2 * q_heads + 2 * kv_heads)
    return ops, io


def roofline_seconds(ops: float, io: float, peak_ops: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over HBM's."""
    return max(ops / peak_ops if peak_ops else 0.0,
               io / PEAKS["hbm_bytes_per_s"])


def sasrec_row_flops(seq: int, d: int, n_blocks: int, d_ff: int = 0) -> int:
    """One SASRec row: per block the q, k, v and output products, both
    causal attention products and the two feed-forward products (2
    operations a multiply-add); gathers, norms and softmax uncounted."""
    d_ff = d_ff or d
    per_block = (2 * seq * d * d * 4 + 2 * seq * (seq + 1) * d
                 + 2 * seq * d * d_ff * 2)
    return n_blocks * per_block


def lm_moe_row_flops(seq: int, d_model: int, n_heads: int, n_kv_heads: int,
                     n_layers: int, n_experts: int, top_k: int, d_ff: int,
                     user_dim: int) -> int:
    """One row of a decoder tower with sparse experts: per token and
    layer the q, k, v, output and router products and the top_k experts'
    three products; per row and layer both causal attention products; the
    user head once. Experts a token is not routed to do not count."""
    hd = d_model // n_heads
    proj = 2 * d_model * hd * (2 * n_heads + 2 * n_kv_heads)
    router = 2 * d_model * n_experts
    expert = top_k * 3 * 2 * d_model * d_ff
    attn = 2 * seq * (seq + 1) * n_heads * hd
    per_layer = seq * (proj + router + expert) + attn
    return n_layers * per_layer + 2 * d_model * user_dim
