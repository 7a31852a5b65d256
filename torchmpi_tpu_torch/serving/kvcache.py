"""Paged KV-cache block pool (vLLM-style accounting, host-side paging).

The port's copy of the JAX package's ``serving/kvcache.py`` (stdlib only).

The pool divides the replica's KV token budget into fixed-size blocks
(``serve_block_size`` tokens each, ``serve_kv_blocks`` total) and leases
them to requests as their sequences grow.  Each request holds an ordered
block list — its page table — and returns every block when it finishes,
is shed, or is evicted.

The device cache itself is slot-strided (see ``engine.LlamaRunner``);
the pool virtualizes
*admission* over that storage: a request cannot enter a decode slot
without leased blocks, the admission gate sheds new work when headroom is
gone, and deadline-aware eviction reclaims blocks from requests that can
no longer meet their deadline (oldest-deadline-first — the LRU axis here
is "least likely to still matter").

Metrics: ``tmpi_kv_blocks_used`` (gauge) and
``tmpi_kv_blocks_evicted_total`` (counter).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class PoolExhausted(Exception):
    """No free blocks to satisfy a lease (admission gate / grow failure)."""


class BlockPool:
    """Fixed-size KV block allocator with per-request block lists.

    Thread-safe: the frontend admits (reserve) from handler threads while
    the engine loop extends/frees from its iteration thread.
    """

    def __init__(self, num_blocks: int, block_size: int, registry=None):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(self.num_blocks - 1, -1, -1))
        # request id -> ordered block list (the request's page table)
        self._tables: Dict[str, List[int]] = {}
        # request id -> tokens currently stored (lease is in blocks,
        # occupancy in tokens; extend() only leases on block boundaries)
        self._tokens: Dict[str, int] = {}
        # request id -> absolute deadline (monotonic seconds), for
        # deadline-aware eviction ordering
        self._deadline: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._registry = registry
        self._publish_used()

    # -- metrics -----------------------------------------------------------
    def _publish_used(self) -> None:
        if self._registry is None:
            return
        used = self.num_blocks - len(self._free)
        self._registry.gauge(
            "tmpi_kv_blocks_used",
            "KV-cache pool blocks currently leased to live requests",
        ).set(float(used), {})

    def _count_evicted(self, n: int) -> None:
        if self._registry is None or n <= 0:
            return
        self._registry.counter(
            "tmpi_kv_blocks_evicted_total",
            "KV-cache blocks reclaimed by deadline-aware eviction",
        ).inc(n)

    # -- accounting reads --------------------------------------------------
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def used_blocks(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    def headroom(self) -> float:
        """Free fraction of the pool — the admission gate's input."""
        with self._lock:
            return len(self._free) / float(self.num_blocks)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` (ceil division)."""
        return max(1, -(-int(n_tokens) // self.block_size))

    def table(self, request_id: str) -> List[int]:
        with self._lock:
            return list(self._tables.get(request_id, ()))

    def holders(self) -> List[str]:
        with self._lock:
            return list(self._tables)

    # -- lease lifecycle ---------------------------------------------------
    def allocate(self, request_id: str, n_tokens: int,
                 deadline: Optional[float] = None) -> List[int]:
        """Lease blocks for a new request's full budget (prompt + max_new).

        Raises :class:`PoolExhausted` without partial allocation if the
        pool cannot cover it — the caller sheds or queues the request.
        """
        need = self.blocks_for(n_tokens)
        with self._lock:
            if request_id in self._tables:
                raise KeyError(f"request {request_id!r} already holds a lease")
            if need > len(self._free):
                raise PoolExhausted(
                    f"need {need} blocks, {len(self._free)} free")
            got = [self._free.pop() for _ in range(need)]
            self._tables[request_id] = got
            self._tokens[request_id] = int(n_tokens)
            if deadline is not None:
                self._deadline[request_id] = float(deadline)
            self._publish_used()
            return list(got)

    def extend(self, request_id: str, n_tokens: int = 1) -> List[int]:
        """Grow a lease by ``n_tokens``; leases new blocks only when the
        occupancy crosses a block boundary.  Returns the new blocks (often
        empty).  Raises :class:`PoolExhausted` if growth cannot be met."""
        with self._lock:
            if request_id not in self._tables:
                raise KeyError(f"request {request_id!r} holds no lease")
            tokens = self._tokens[request_id] + int(n_tokens)
            need = self.blocks_for(tokens) - len(self._tables[request_id])
            if need > len(self._free):
                raise PoolExhausted(
                    f"need {need} more blocks, {len(self._free)} free")
            got = [self._free.pop() for _ in range(max(0, need))]
            self._tables[request_id].extend(got)
            self._tokens[request_id] = tokens
            self._publish_used()
            return got

    def release(self, request_id: str) -> int:
        """Return a request's blocks to the pool (finish/shed). Idempotent;
        returns the number of blocks freed."""
        with self._lock:
            blocks = self._tables.pop(request_id, None)
            self._tokens.pop(request_id, None)
            self._deadline.pop(request_id, None)
            if not blocks:
                return 0
            self._free.extend(blocks)
            self._publish_used()
            return len(blocks)

    # -- eviction ----------------------------------------------------------
    def evict_expired(self, now: float) -> List[str]:
        """Reclaim every lease whose deadline has passed.  Returns the
        evicted request ids (the engine sheds them with reason=deadline)."""
        with self._lock:
            victims = [rid for rid, dl in self._deadline.items() if dl <= now]
        freed = 0
        for rid in victims:
            freed += self.release(rid)
        self._count_evicted(freed)
        return victims

    def evict_for(self, need_blocks: int, now: float,
                  protect: Any = ()) -> List[str]:
        """Deadline-aware eviction to free ``need_blocks``: victims are
        chosen oldest-deadline-first (closest to expiry — least likely to
        still complete in time), skipping ids in ``protect``.  Returns the
        evicted request ids; may free fewer blocks than asked."""
        protect = set(protect)
        evicted: List[str] = []
        freed = 0
        while True:
            with self._lock:
                if need_blocks <= len(self._free):
                    break
                candidates = [
                    (self._deadline.get(rid, float("inf")), rid)
                    for rid in self._tables if rid not in protect
                ]
                if not candidates:
                    break
                _, victim = min(candidates)
            freed += self.release(victim)
            evicted.append(victim)
        self._count_evicted(freed)
        return evicted

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free": len(self._free),
                "used": self.num_blocks - len(self._free),
                "holders": len(self._tables),
            }
