"""Key-range partitioning for the aggregation plane: the consistent ring.

A copy of `krr_tpu/federation/ring.py` over the port's modules.

``--federation-ring`` shards the AGGREGATOR, not the scanner: a shard
keeps scanning its clusters whole, but splits each tick's captured delta
ops by *owning aggregator* and streams every partition over its own
KRRFED1 connection with independent epoch watermarks. The mapping is a
classic consistent-hash ring — each aggregator node projects ``vnodes``
points onto a 64-bit circle (BLAKE2b of ``"{name}#{i}"``), and a key is
owned by the first node point at or clockwise past ``hash(key)``.

Why consistent hashing (and not modulo): adding or removing one node must
move ONLY the keys on the ranges that node gains or loses (≈ ``1/N`` of
the keyspace, spread across its vnodes) — every other key keeps its owner,
so its aggregator keeps its accumulated digest rows and epoch watermarks.
A modulo partition would reshuffle nearly every key on any resize,
forcing fleet-wide snapshot re-syncs. The stability property is pinned by
a join/leave test in ``tests/test_federation.py``.

Determinism: the hash is keyed on stable strings only (node names, object
keys), so every shard — and every future process — derives the identical
assignment from the identical ``--federation-ring`` flag. No coordination
service, no rebalance protocol: the flag IS the ring state.

A node spec may name standby endpoints (``name=host:port|host2:port2``):
the shard streams the node's partition to EVERY endpoint independently
(same records, same epochs — a replicated WAL on the wire), so a standby
aggregator holds the full key-range state and takes over on primary death
with zero lost epochs (each endpoint acks its own watermark; a lagging
endpoint that can no longer resume from the shard's pruned buffer falls
back to a snapshot re-sync).
"""

from __future__ import annotations

import hashlib
from bisect import bisect_right
from dataclasses import dataclass

import numpy as np

#: Ring points each node projects. 64 keeps the per-node keyspace share
#: within a few percent of 1/N at single-digit N without making the ring
#: build or the bisect lookups measurable.
DEFAULT_VNODES = 64


def _hash64(value: str) -> int:
    """Stable 64-bit ring position (BLAKE2b, process-independent)."""
    return int.from_bytes(
        hashlib.blake2b(value.encode("utf-8"), digest_size=8).digest(), "big"
    )


@dataclass(frozen=True)
class RingNode:
    """One aggregator in the ring: a stable name (the hash identity — the
    endpoints can move without moving keys) plus its endpoints, primary
    first, standbys after."""

    name: str
    endpoints: "tuple[tuple[str, int], ...]"


def parse_ring(value: str, flag: str = "--federation-ring") -> "list[RingNode]":
    """``name=host:port[|host:port...],name2=...`` → ring nodes. The NAME
    is the hash identity: re-pointing a node's endpoints (failover, pod
    reschedule) moves zero keys."""
    from krr_tpu_torch.federation.shard import parse_endpoint

    nodes: "list[RingNode]" = []
    seen: "set[str]" = set()
    for spec in value.split(","):
        spec = spec.strip()
        if not spec:
            continue
        name, sep, endpoints_spec = spec.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"{flag} entries must be name=host:port[|host:port...], got {spec!r}"
            )
        if name in seen:
            raise ValueError(f"{flag} names a node twice: {name!r}")
        seen.add(name)
        endpoints = tuple(
            parse_endpoint(endpoint.strip(), flag)
            for endpoint in endpoints_spec.split("|")
            if endpoint.strip()
        )
        if not endpoints:
            raise ValueError(f"{flag} node {name!r} names no endpoints")
        nodes.append(RingNode(name=name, endpoints=endpoints))
    if not nodes:
        raise ValueError(f"{flag} names no nodes")
    return nodes


class HashRing:
    """The key → aggregator-name assignment (bisect over sorted vnode
    points). Pure and immutable: shards rebuild one from the flag; tests
    build joined/left variants to pin the bounded-churn property."""

    def __init__(self, nodes: "list[RingNode]", *, vnodes: int = DEFAULT_VNODES) -> None:
        if not nodes:
            raise ValueError("a hash ring needs at least one node")
        self.nodes: "dict[str, RingNode]" = {node.name: node for node in nodes}
        points = sorted(
            (_hash64(f"{node.name}#{i}"), node.name)
            for node in nodes
            for i in range(int(vnodes))
        )
        self._hashes = [point for point, _ in points]
        self._names = [name for _, name in points]

    def owner(self, key: str) -> str:
        """The owning node NAME for ``key`` (first point clockwise)."""
        i = bisect_right(self._hashes, _hash64(key))
        return self._names[i if i < len(self._names) else 0]

    def spread(self, keys) -> "dict[str, int]":
        """Owned-key counts per node over ``keys`` (every node present,
        zero included) — the shard's ring-placement gauges."""
        counts = {name: 0 for name in self.nodes}
        for key in keys:
            counts[self.owner(key)] += 1
        return counts


def _gather_ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat indices covering ``[starts[i], starts[i] + lengths[i])`` for
    every i, concatenated — the vectorized CSR row-subset gather."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    offsets = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return np.repeat(starts, lengths) + (np.arange(total, dtype=np.int64) - offsets)


def partition_ops(ops: list, owner_of) -> "dict[str, list]":
    """Split captured store ops (`DigestStore.pending_ops` shapes) by
    owning node. Row slices are plain fancy-index copies of the same
    float32 values, so folding each partition into its own store and
    unioning the stores is bit-identical to folding the unsplit ops into
    one store (per-key row order within a record is preserved; digest
    folds are per-row adds/maxes with no cross-row coupling).

    Requires every op to carry its key list (shards run with
    ``capture_full_keys`` on — a keys-elided whole-store fold cannot be
    partitioned because its row meaning lives in the TARGET store).
    """
    out: "dict[str, list]" = {}
    for op in ops:
        kind, keys = op[0], op[1]
        if keys is None:
            raise ValueError(
                "ring partitioning requires captured key lists "
                "(DigestStore.capture_full_keys) — got a keys-elided fold"
            )
        groups: "dict[str, list[int]]" = {}
        for i, key in enumerate(keys):
            groups.setdefault(owner_of(key), []).append(i)
        if kind in ("grow", "drop"):
            for name, idx in groups.items():
                out.setdefault(name, []).append((kind, [keys[i] for i in idx]))
        elif kind == "fold":
            _, _, cpu_counts, cpu_total, cpu_peak, mem_total, mem_peak = op
            for name, idx in groups.items():
                rows = np.asarray(idx, dtype=np.int64)
                out.setdefault(name, []).append(
                    (
                        "fold",
                        [keys[i] for i in idx],
                        np.asarray(cpu_counts)[rows],
                        np.asarray(cpu_total)[rows],
                        np.asarray(cpu_peak)[rows],
                        np.asarray(mem_total)[rows],
                        np.asarray(mem_peak)[rows],
                    )
                )
        elif kind == "fold_csr":
            _, _, vals, cols, indptr, cpu_total, cpu_peak, mem_total, mem_peak = op
            indptr = np.asarray(indptr)
            lengths_all = np.diff(indptr)
            for name, idx in groups.items():
                rows = np.asarray(idx, dtype=np.int64)
                lengths = lengths_all[rows].astype(np.int64, copy=False)
                flat = _gather_ranges(indptr[:-1][rows].astype(np.int64), lengths)
                sub_indptr = np.concatenate(
                    [np.zeros(1, dtype=np.int64), np.cumsum(lengths)]
                ).astype(indptr.dtype, copy=False)
                out.setdefault(name, []).append(
                    (
                        "fold_csr",
                        [keys[i] for i in idx],
                        np.asarray(vals)[flat],
                        np.asarray(cols)[flat],
                        sub_indptr,
                        np.asarray(cpu_total)[rows],
                        np.asarray(cpu_peak)[rows],
                        np.asarray(mem_total)[rows],
                        np.asarray(mem_peak)[rows],
                    )
                )
        else:
            raise ValueError(f"unknown captured op kind {kind!r}")
    return out
