"""Uniform-fanout neighbor sampler over a CSR adjacency (numpy, host side).

A copy of ``repro/models/sampler.py``, which imports no JAX: the same
numpy draws give the same arrays for the same seed.

The ``minibatch_lg`` shape requires a *real* sampler: seed nodes → fanout-15
frontier → fanout-10 frontier, returned as a padded static-shape subgraph the
jitted GIN step consumes unchanged every iteration (XLA-friendly).

Padding contract (models/gnn.py): node rows beyond ``n_valid`` carry zero
features; padding edges have ``sender == -1`` and are dropped by the
aggregation's scratch-row trick.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed sparse row adjacency. indptr (N+1,), indices (E,)."""

    indptr: np.ndarray
    indices: np.ndarray
    node_feats: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_edge_list(senders: np.ndarray, receivers: np.ndarray,
                       n_nodes: int, **kw) -> "CSRGraph":
        order = np.argsort(receivers, kind="stable")
        s, r = senders[order], receivers[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, r + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr=indptr, indices=s.astype(np.int32), **kw)


def synthetic_power_law_graph(n_nodes: int, n_edges: int, d_feat: int,
                              n_classes: int = 64, alpha: float = 1.5,
                              seed: int = 0) -> CSRGraph:
    """Preferential-attachment-ish graph at arbitrary scale (used for tests
    and benchmarks at reduced size; the full ogbn-scale graph exists only as
    ShapeDtypeStructs in the dry-run)."""
    rng = np.random.default_rng(seed)
    # power-law degree propensity
    w = rng.pareto(alpha, n_nodes) + 1.0
    p = w / w.sum()
    senders = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    receivers = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    feats = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    return CSRGraph.from_edge_list(senders, receivers, n_nodes,
                                   node_feats=feats, labels=labels)


class NeighborSampler:
    """Uniform fanout sampling with static padded output shapes."""

    def __init__(self, graph: CSRGraph, fanout: Tuple[int, ...],
                 batch_nodes: int, seed: int = 0):
        self.g = graph
        self.fanout = tuple(fanout)
        self.batch_nodes = batch_nodes
        self.rng = np.random.default_rng(seed)
        # static capacities
        self.max_nodes = batch_nodes
        self.max_edges = 0
        frontier = batch_nodes
        for f in self.fanout:
            self.max_edges += frontier * f
            frontier *= f
            self.max_nodes += frontier

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """For each node draw ≤ fanout distinct-ish neighbors (with
        replacement — unbiased for aggregation means, standard GraphSAGE)."""
        lo = self.g.indptr[nodes]
        hi = self.g.indptr[nodes + 1]
        deg = (hi - lo).astype(np.int64)
        has = deg > 0
        draws = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                  size=(nodes.size, fanout))
        nbrs = self.g.indices[(lo[:, None] + draws).astype(np.int64)]
        src = nbrs[has]
        dst = np.repeat(nodes, fanout).reshape(nodes.size, fanout)[has]
        return src.ravel().astype(np.int32), dst.ravel().astype(np.int32)

    def sample(self, seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """Returns a padded subgraph dict for gnn.Graph, with local ids:
        node 0..n_valid-1 (seeds first), features gathered, edges local."""
        assert seeds.size == self.batch_nodes
        layer_nodes = [seeds.astype(np.int32)]
        senders_g, receivers_g = [], []
        frontier = seeds.astype(np.int32)
        for f in self.fanout:
            src, dst = self._sample_neighbors(frontier, f)
            senders_g.append(src)
            receivers_g.append(dst)
            frontier = np.unique(src)
            layer_nodes.append(frontier)

        all_global = np.unique(np.concatenate(layer_nodes))
        # seeds must be the FIRST batch_nodes local ids
        rest = np.setdiff1d(all_global, seeds, assume_unique=False)
        ordered = np.concatenate([seeds.astype(np.int32),
                                  rest.astype(np.int32)])
        local = {g: i for i, g in enumerate(ordered.tolist())}
        n_valid = ordered.size

        s = np.concatenate(senders_g) if senders_g else np.zeros(0, np.int32)
        r = np.concatenate(receivers_g) if receivers_g else s
        s_l = np.fromiter((local[x] for x in s.tolist()), np.int32, s.size)
        r_l = np.fromiter((local[x] for x in r.tolist()), np.int32, r.size)

        feats = np.zeros((self.max_nodes, self.g.node_feats.shape[1]),
                         np.float32)
        feats[:n_valid] = self.g.node_feats[ordered]
        labels = np.zeros((self.max_nodes,), np.int32)
        if self.g.labels is not None:
            labels[:n_valid] = self.g.labels[ordered]

        senders = np.full((self.max_edges,), -1, np.int32)
        receivers = np.zeros((self.max_edges,), np.int32)
        n_e = min(s_l.size, self.max_edges)
        senders[:n_e] = s_l[:n_e]
        receivers[:n_e] = r_l[:n_e]

        mask = np.zeros((self.max_nodes,), bool)
        mask[:self.batch_nodes] = True            # loss on seed nodes only
        return {
            "node_feats": feats, "senders": senders, "receivers": receivers,
            "labels": labels, "mask": mask,
            "n_valid_nodes": n_valid, "n_valid_edges": int(n_e),
        }
