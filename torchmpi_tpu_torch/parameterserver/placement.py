"""Consistent-hash shard placement for the replicated multi-server PS.

The port's copy of ``torchmpi_tpu/parameterserver/placement.py``: every
key must place on the same slot in both packages, since a server of either
serves clients of both (``tests/test_torch_parameterserver.py`` holds the
two rings key for key).

The single-server design addressed shards positionally — "shard k lives
on ``endpoints[k]``".  The replicated group (docs/parameterserver.md
"Replication & shard placement") instead places every shard key on a
**placement ring**: each server *slot* contributes ``vnodes`` virtual
points hashed from its slot id, and a key is owned by the first point at
or clockwise-after the key's own hash.  The backup is the next DISTINCT
slot walking the same direction — which is exactly the slot that becomes
the owner when the primary leaves the ring, the property client-side
promotion relies on (the backup already holds the forwarded replica).

Design properties:

* **Deterministic across processes.**  Points come from blake2b over the
  literal strings ``"slot:<id>:<vnode>"`` / ``"key:<key>"`` — no Python
  ``hash()`` (salted per process), no RNG.  Every client of a cluster
  derives the identical shard→server map from the membership list alone;
  there is no placement master to ask and nothing to gossip.
* **Bounded imbalance.**  With the default 128 vnodes/slot the max/mean
  owned-key ratio stays under the pinned bound for small-N groups.
* **Minimal movement.**  Removing a slot reassigns ONLY the keys it
  owned (to each key's old backup — by construction, the successor walk
  is the same).  Adding a slot steals only the keys the new slot's
  points capture (≈ keys/(N+1)); every moved key moves TO the new slot.

Slots are **stable small integers** (the index into the cluster's
endpoint list), not host:port strings, so a server restarted elsewhere —
or a live handoff target — *inherits* its slot's ring identity and zero
keys move; membership changes (a slot dying for good, a scale-out join)
are the only events that move keys.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["PlacementRing", "DEFAULT_VNODES"]

#: virtual points per slot; the imbalance bound in the property tests is
#: calibrated against this default (more vnodes = flatter, slower build).
DEFAULT_VNODES = 128


def _h64(s: str) -> int:
    """Stable 64-bit point hash (blake2b is in hashlib everywhere; the
    8-byte digest is plenty for a ring with a few thousand points)."""
    return int.from_bytes(
        hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "big")


class PlacementRing:
    """Immutable consistent-hash ring over integer slots.

    ``owner(key)`` / ``owner_backup(key)`` are the only lookups the
    client fast path uses; ``without``/``with_slot`` build the
    post-membership-change ring (promotion, scale-out) without mutating
    the one concurrent lookups may be reading.
    """

    def __init__(self, slots: Iterable[int], vnodes: int = DEFAULT_VNODES):
        self.slots: Tuple[int, ...] = tuple(sorted(set(int(s) for s in slots)))
        self.vnodes = int(vnodes)
        if self.vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        points: List[Tuple[int, int]] = []
        for slot in self.slots:
            for v in range(self.vnodes):
                points.append((_h64(f"slot:{slot}:{v}"), slot))
        # Sort by (hash, slot): a (vanishingly unlikely) 64-bit point
        # collision still orders deterministically on every process.
        points.sort()
        self._hashes = [p[0] for p in points]
        self._owners = [p[1] for p in points]

    # ------------------------------------------------------------- lookups

    def _walk(self, key: str) -> Iterable[int]:
        """Slots in ring order starting at the key's position (with
        repeats — callers de-dup)."""
        if not self._hashes:
            return
        start = bisect.bisect_left(self._hashes, _h64(f"key:{key}"))
        n = len(self._owners)
        for i in range(n):
            yield self._owners[(start + i) % n]

    def owner(self, key: str) -> int:
        """The slot owning ``key`` (the primary)."""
        for slot in self._walk(key):
            return slot
        raise ValueError("placement ring is empty")

    def owner_backup(self, key: str) -> Tuple[int, Optional[int]]:
        """(primary, backup) for ``key``; backup is ``None`` in a
        single-slot ring.  The backup is the next DISTINCT slot clockwise
        — the owner of ``key`` in ``self.without(primary)``."""
        primary: Optional[int] = None
        for slot in self._walk(key):
            if primary is None:
                primary = slot
            elif slot != primary:
                return primary, slot
        if primary is None:
            raise ValueError("placement ring is empty")
        return primary, None

    # ---------------------------------------------------------- membership

    def without(self, slot: int) -> "PlacementRing":
        """The ring after ``slot`` leaves (promotion/permanent death)."""
        return PlacementRing((s for s in self.slots if s != int(slot)),
                             self.vnodes)

    def with_slot(self, slot: int) -> "PlacementRing":
        """The ring after ``slot`` joins (scale-out)."""
        return PlacementRing((*self.slots, int(slot)), self.vnodes)

    # --------------------------------------------------------- diagnostics

    def assignment(self, keys: Sequence[str]) -> Dict[str, int]:
        return {k: self.owner(k) for k in keys}

    def load(self, keys: Sequence[str]) -> Dict[int, int]:
        """Owned-key count per slot (bench/test surface)."""
        counts = {s: 0 for s in self.slots}
        for k in keys:
            counts[self.owner(k)] += 1
        return counts

    def __repr__(self) -> str:
        return (f"PlacementRing<slots={self.slots}, vnodes={self.vnodes}, "
                f"points={len(self._hashes)}>")
