"""Host-plane ring collectives over TCP (binding to ``_native/hostcomm.cpp``).

Counterpart of ``torchmpi_tpu/collectives/hostcomm.py``.  The card's
collectives go through ``torch.distributed`` and the ring kernels; this is
the *host* plane: processes reducing, broadcasting and gathering buffers in
host memory over TCP without a process group.  The native library is the
port's copy of the JAX package's source, so a ring may mix ranks of both
packages.

Each rank knows every endpoint in rank order and wires only its ring
neighbours (it connects to the next and accepts the previous).  Every
collective works in place on a contiguous CPU tensor (pinned or not) and
must be called by every rank of the ring at once.  The library reads and
writes the tensor's memory through ``data_ptr()``: no copy, no numpy.
Dtypes: float32, float64, int32, int64, bfloat16, int8 (saturating sums)
and float16; ops sum, max and min.

A ring built with ``io_deadline_ms > 0`` raises :class:`HostcommTimeout`
when a wait makes no progress for that long; with 0 (the knob's default) a
stalled peer is waited for forever.
"""

from __future__ import annotations

import ctypes
import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import torch

from .._native.build import build_library
from ..obs import tracer as _tracer
from ..runtime.failure import (HostcommCorruption, HostcommError,
                               HostcommTimeout)
from ..runtime.handles import SynchronizationHandle

# The native dtype codes (the JAX package's, by element type).
_DTYPES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.int32: 2,
    torch.int64: 3,
    torch.bfloat16: 4,
    torch.int8: 5,
    torch.float16: 6,
}
_OPS = {"sum": 0, "max": 1, "min": 2}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    """The native library, built and loaded at the first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            L = ctypes.CDLL(build_library("tmpi_hc", ["hostcomm.cpp"]))
            i32, u32, u64, vp = (ctypes.c_int, ctypes.c_uint32,
                                 ctypes.c_uint64, ctypes.c_void_p)
            L.tmpi_hc_create.argtypes = [i32, i32, ctypes.c_char_p, i32, i32,
                                         i32, i32]
            L.tmpi_hc_create.restype = i32
            L.tmpi_hc_last_error.argtypes = [i32, ctypes.c_char_p, i32]
            L.tmpi_hc_last_error.restype = i32
            L.tmpi_hc_free.argtypes = [i32]
            # A void function's restype must be None: ctypes' default, c_int,
            # would read a stale return register.
            L.tmpi_hc_free.restype = None
            L.tmpi_hc_allreduce.argtypes = [i32, vp, u64, u32, u32, u64]
            L.tmpi_hc_allreduce.restype = i32
            L.tmpi_hc_broadcast.argtypes = [i32, vp, u64, u32, i32, u64]
            L.tmpi_hc_broadcast.restype = i32
            L.tmpi_hc_reduce.argtypes = [i32, vp, u64, u32, u32, i32, u64]
            L.tmpi_hc_reduce.restype = i32
            L.tmpi_hc_sendreceive.argtypes = [i32, vp, u64, u32, i32, i32, u64]
            L.tmpi_hc_sendreceive.restype = i32
            L.tmpi_hc_exchange_counts.argtypes = [i32, u64, vp]
            L.tmpi_hc_exchange_counts.restype = i32
            L.tmpi_hc_allgatherv.argtypes = [i32, vp, u64, vp, vp, u32]
            L.tmpi_hc_allgatherv.restype = i32
            L.tmpi_hc_barrier.argtypes = [i32]
            L.tmpi_hc_barrier.restype = i32
            # The native trace ring: declared, and left off (its drain and
            # clock alignment come with the port's obs/native.py).
            L.tmpi_hc_set_trace.argtypes = [i32, i32]
            L.tmpi_hc_set_trace.restype = None
            L.tmpi_hc_trace_drain.argtypes = [vp, i32]
            L.tmpi_hc_trace_drain.restype = i32
            L.tmpi_hc_trace_dropped.argtypes = []
            L.tmpi_hc_trace_dropped.restype = u64
            L.tmpi_hc_set_correlation.argtypes = [i32, u64]
            L.tmpi_hc_set_correlation.restype = None
            L.tmpi_hc_set_clock_offset.argtypes = [ctypes.c_int64]
            L.tmpi_hc_set_clock_offset.restype = None
            _lib = L
        return _lib


def _chunk_bytes(x: torch.Tensor, small_cutoff_key: Optional[str]) -> int:
    """Transfer piece size from the buffer-geometry knobs: a message at or
    below the small cutoff (an element count) moves as one piece (0);
    larger ones in pieces within [min_buffer_size_cpu,
    max_buffer_size_cpu], one per in-flight buffer, rounded down to whole
    elements."""
    from ..runtime import config

    if (small_cutoff_key is not None
            and x.numel() <= int(config.get(small_cutoff_key))):
        return 0
    nbytes, itemsize = x.numel() * x.element_size(), x.element_size()
    nbuf = max(1, int(config.get("num_buffers_per_collective")))
    lo = int(config.get("min_buffer_size_cpu"))
    hi = int(config.get("max_buffer_size_cpu"))
    piece = max(lo, min(hi, nbytes // nbuf or nbytes))
    piece -= piece % itemsize
    return 0 if piece >= nbytes or piece <= 0 else piece


def free_ports(n: int) -> List[int]:
    """n distinct free TCP ports on the loopback interface (bound, then
    released)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class HostCommunicator:
    """One rank of a host-plane ring.  ``endpoints``: ``[(host, port)]`` in
    rank order, the same on every rank; this rank listens on
    ``endpoints[rank]``'s port.  ``timeout_ms`` bounds the wiring;
    ``io_timeout_ms`` is the progress-warning interval (default
    ``deadlock_timeout_seconds``), ``io_deadline_ms`` the hard deadline of
    a wait (default ``hc_io_deadline_ms``) and ``frame_crc`` the frame
    trailers (default ``hc_frame_crc``)."""

    def __init__(self, rank: int, size: int,
                 endpoints: Sequence[Tuple[str, int]],
                 timeout_ms: int = 10000,
                 io_timeout_ms: Optional[int] = None,
                 io_deadline_ms: Optional[int] = None,
                 frame_crc: Optional[bool] = None):
        from ..runtime import config

        if len(endpoints) != size:
            raise ValueError("one endpoint per rank required")
        self.rank, self.size = rank, size
        if io_timeout_ms is None:
            io_timeout_ms = int(
                float(config.get("deadlock_timeout_seconds")) * 1000)
        if io_deadline_ms is None:
            io_deadline_ms = int(config.get("hc_io_deadline_ms"))
        if frame_crc is None:
            frame_crc = bool(config.get("hc_frame_crc"))
        ep = ",".join(f"{h}:{p}" for h, p in endpoints)
        self._id = lib().tmpi_hc_create(rank, size, ep.encode(), timeout_ms,
                                        io_timeout_ms, io_deadline_ms,
                                        1 if frame_crc else 0)
        if self._id < 0:
            raise HostcommError(
                f"host ring rank {rank}/{size} failed to wire ({ep})")
        # One worker thread, and every operation (sync and async) runs on
        # it: two collectives on the same sockets at once would interleave
        # their byte streams.  A sync call made while an async one is in
        # flight queues behind it.
        self._worker_ident: Optional[int] = None

        def _capture_ident():
            self._worker_ident = threading.get_ident()

        self._pool = ThreadPoolExecutor(max_workers=1,
                                        initializer=_capture_ident)

    def _submit(self, fn, *args):
        """Every operation goes through here.  A collective called from the
        ring's own worker thread (inside an async handle's callback, say)
        would queue behind itself forever: it raises instead."""
        if threading.get_ident() == self._worker_ident:
            raise RuntimeError(
                "host collective called from this communicator's own worker "
                "thread (would self-deadlock); call from the controller "
                "thread or another executor")
        return self._pool.submit(fn, *args)

    def _traced(self, opname: str, nbytes: int, fn, *args):
        with _tracer.span(f"hostcomm.{opname}", bytes=nbytes, rank=self.rank):
            return self._submit(fn, *args).result()

    def _traced_async(self, fn, *args) -> SynchronizationHandle:
        return SynchronizationHandle.from_native(
            self._submit(fn, *args).result)

    def close(self) -> None:
        """Drain the operations in flight, then free the native ring."""
        self._pool.shutdown(wait=True)
        if self._id > 0:
            lib().tmpi_hc_free(self._id)
            self._id = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- ops

    def _raise(self, op: str) -> None:
        """Raise the typed error the native side recorded for this ring:
        HostcommTimeout (the deadline expired with no progress),
        HostcommCorruption (a frame's CRC32 did not match), else
        HostcommError.  The ring is poisoned: make a fresh one."""
        buf = ctypes.create_string_buffer(512)
        code = lib().tmpi_hc_last_error(self._id, buf, len(buf))
        msg = buf.value.decode(errors="replace") or f"host ring {op} failed"
        if code == 1:
            raise HostcommTimeout(msg)
        if code == 2:
            raise HostcommCorruption(msg)
        raise HostcommError(msg)

    @staticmethod
    def _check(x: torch.Tensor) -> None:
        if not isinstance(x, torch.Tensor):
            raise ValueError("host collectives take torch tensors, got "
                             f"{type(x).__name__}")
        if x.device.type != "cpu":
            raise ValueError(f"host collectives take CPU tensors, got one on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError("host collectives need contiguous tensors")
        if x.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {x.dtype}")

    def _allreduce_impl(self, x: torch.Tensor, op: str) -> torch.Tensor:
        cb = _chunk_bytes(x, "small_allreduce_size_cpu")
        if lib().tmpi_hc_allreduce(self._id, x.data_ptr(), x.numel(),
                                   _DTYPES[x.dtype], _OPS[op], cb) != 1:
            self._raise("allreduce")
        return x

    def _broadcast_impl(self, x: torch.Tensor, root: int) -> torch.Tensor:
        from ..runtime import config

        # One piece up to the tree cutoff, buffer-size pieces above it.
        if x.numel() * x.element_size() <= int(
                config.get("bcast_size_tree_based")):
            cb = 0
        else:
            cb = _chunk_bytes(x, None)
        if lib().tmpi_hc_broadcast(self._id, x.data_ptr(), x.numel(),
                                   _DTYPES[x.dtype], root, cb) != 1:
            self._raise("broadcast")
        return x

    def _reduce_impl(self, x: torch.Tensor, op: str,
                     root: int) -> torch.Tensor:
        cb = _chunk_bytes(x, "small_allreduce_size_cpu")
        if lib().tmpi_hc_reduce(self._id, x.data_ptr(), x.numel(),
                                _DTYPES[x.dtype], _OPS[op], root, cb) != 1:
            self._raise("reduce")
        return x

    def _sendreceive_impl(self, x: torch.Tensor, src: int,
                          dst: int) -> torch.Tensor:
        cb = _chunk_bytes(x, None)
        if lib().tmpi_hc_sendreceive(self._id, x.data_ptr(), x.numel(),
                                     _DTYPES[x.dtype], src, dst, cb) != 1:
            self._raise("sendreceive")
        return x

    def _allgather_impl(self, x: torch.Tensor) -> torch.Tensor:
        counts = torch.zeros(self.size, dtype=torch.int64)   # the uint64s
        if lib().tmpi_hc_exchange_counts(self._id, x.numel(),
                                         counts.data_ptr()) != 1:
            self._raise("allgather")
        out = torch.empty(int(counts.sum()), dtype=x.dtype)
        if lib().tmpi_hc_allgatherv(self._id, x.data_ptr(), x.numel(),
                                    counts.data_ptr(), out.data_ptr(),
                                    _DTYPES[x.dtype]) != 1:
            self._raise("allgather")
        return out

    def _barrier_impl(self) -> None:
        if lib().tmpi_hc_barrier(self._id) != 1:
            self._raise("barrier")

    def _check_op(self, op: str) -> None:
        if op not in _OPS:
            raise ValueError(f"op must be one of {sorted(_OPS)}")

    def _check_rank(self, r: int, what: str) -> None:
        if not 0 <= r < self.size:
            raise ValueError(f"{what} {r} out of range")

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In place: every rank's tensor reduced by ``op`` (chunked ring)."""
        self._check(x)
        self._check_op(op)
        return self._traced("allreduce", x.nbytes, self._allreduce_impl, x,
                            op)

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """In place: rank ``root``'s tensor on every rank (pipelined ring
        walk)."""
        self._check(x)
        self._check_rank(root, "root")
        return self._traced("broadcast", x.nbytes, self._broadcast_impl, x,
                            root)

    def reduce(self, x: torch.Tensor, op: str = "sum",
               root: int = 0) -> torch.Tensor:
        """In place on ``root``: the reduction; every other rank's tensor
        is left as it was."""
        self._check(x)
        self._check_op(op)
        self._check_rank(root, "root")
        return self._traced("reduce", x.nbytes, self._reduce_impl, x, op,
                            root)

    def sendreceive(self, x: torch.Tensor, src: int,
                    dst: int) -> torch.Tensor:
        """In place on ``dst``: rank ``src``'s tensor; every other rank's is
        left as it was."""
        self._check(x)
        self._check_rank(src, "src")
        self._check_rank(dst, "dst")
        return self._traced("sendreceive", x.nbytes, self._sendreceive_impl,
                            x, src, dst)

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """A new flat tensor: every rank's tensor (of any size) flattened,
        in rank order."""
        self._check(x)
        return self._traced("allgather", x.nbytes, self._allgather_impl, x)

    def barrier(self) -> None:
        self._traced("barrier", 0, self._barrier_impl)

    # ------------------------------------------------ async (on the worker)

    def allreduce_async(self, x: torch.Tensor,
                        op: str = "sum") -> SynchronizationHandle:
        self._check(x)
        self._check_op(op)
        return self._traced_async(self._allreduce_impl, x, op)

    def broadcast_async(self, x: torch.Tensor,
                        root: int = 0) -> SynchronizationHandle:
        self._check(x)
        self._check_rank(root, "root")
        return self._traced_async(self._broadcast_impl, x, root)

    def reduce_async(self, x: torch.Tensor, op: str = "sum",
                     root: int = 0) -> SynchronizationHandle:
        self._check(x)
        self._check_op(op)
        self._check_rank(root, "root")
        return self._traced_async(self._reduce_impl, x, op, root)

    def sendreceive_async(self, x: torch.Tensor, src: int,
                          dst: int) -> SynchronizationHandle:
        self._check(x)
        self._check_rank(src, "src")
        self._check_rank(dst, "dst")
        return self._traced_async(self._sendreceive_impl, x, src, dst)

    def allgather_async(self, x: torch.Tensor) -> SynchronizationHandle:
        self._check(x)
        return self._traced_async(self._allgather_impl, x)


class HierarchicalHostCommunicator:
    """Two-level host plane: a ring in each group composed with a ring over
    the groups' roots, the 2- and 3-step algebra of the tree collectives
    (``collectives/hierarchical.py``) carried onto the TCP rings.  The
    longest ring is max(group, number of groups) long, not the world.

    ``groups``: global-rank groups, disjoint, covering 0..size-1 (uneven
    sizes are fine); a group's first rank is its root.
    ``intra_endpoints``: one ``(host, port)`` per global rank, wiring each
    group's ring.  ``inter_endpoints``: one per group, on other ports; only
    the roots bind them.

    The collectives match :class:`HostCommunicator`'s: in place, called by
    every global rank at once; reduce leaves every other rank's tensor as
    it was; allgather returns a new tensor in (group, position) order.
    """

    def __init__(self, rank: int, groups: Sequence[Sequence[int]],
                 intra_endpoints: Sequence[Tuple[str, int]],
                 inter_endpoints: Sequence[Tuple[str, int]],
                 timeout_ms: int = 10000,
                 io_timeout_ms: Optional[int] = None,
                 io_deadline_ms: Optional[int] = None,
                 frame_crc: Optional[bool] = None):
        flat = sorted(r for g in groups for r in g)
        if flat != list(range(len(flat))):
            raise ValueError(f"groups must partition 0..n-1, got {groups}")
        if len(inter_endpoints) != len(groups):
            raise ValueError("one inter endpoint per group required")
        if len(intra_endpoints) != len(flat):
            raise ValueError("one intra endpoint per global rank required")
        self.rank, self.size = rank, len(flat)
        self.groups = [list(g) for g in groups]
        self.group_index = next((i for i, g in enumerate(self.groups)
                                 if rank in g), -1)
        if self.group_index < 0:
            raise ValueError(f"rank {rank} not in any group of {groups}")
        group = self.groups[self.group_index]
        self.intra_rank = group.index(rank)
        self.is_root = self.intra_rank == 0
        ring_kw = dict(timeout_ms=timeout_ms, io_timeout_ms=io_timeout_ms,
                       io_deadline_ms=io_deadline_ms, frame_crc=frame_crc)
        self.intra = HostCommunicator(
            self.intra_rank, len(group), [intra_endpoints[r] for r in group],
            **ring_kw)
        # Only the roots join the ring over the groups.
        self.inter: Optional[HostCommunicator] = None
        if self.is_root:
            self.inter = HostCommunicator(
                self.group_index, len(self.groups), list(inter_endpoints),
                **ring_kw)

    def close(self) -> None:
        if self.inter is not None:
            self.inter.close()
        self.intra.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _locate(self, root: int) -> Tuple[int, int]:
        for gi, g in enumerate(self.groups):
            if root in g:
                return gi, g.index(root)
        raise ValueError(f"root {root} out of range")

    def allreduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """3 steps: reduce in each group to its root, allreduce over the
        roots, broadcast in each group."""
        self.intra.reduce(x, op=op, root=0)
        if self.inter is not None:
            self.inter.allreduce(x, op=op)
        self.intra.broadcast(x, root=0)
        return x

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Root's group root learns the tensor, the roots pass it on, each
        group fans it out."""
        gi, idx = self._locate(root)
        if self.group_index == gi and idx != 0:
            self.intra.sendreceive(x, src=idx, dst=0)
        if self.inter is not None:
            self.inter.broadcast(x, root=gi)
        self.intra.broadcast(x, root=0)
        return x

    def reduce(self, x: torch.Tensor, op: str = "sum",
               root: int = 0) -> torch.Tensor:
        """Reduce in each group, reduce over the roots to root's group,
        deliver inside it.  Every rank but ``root`` gets its tensor back as
        it was, the intermediate group roots' included."""
        gi, idx = self._locate(root)
        saved = None
        if self.rank != root and (self.is_root or
                                  (self.group_index == gi and idx != 0)):
            saved = x.clone()
        self.intra.reduce(x, op=op, root=0)
        if self.inter is not None:
            self.inter.reduce(x, op=op, root=gi)
        if idx != 0 and self.group_index == gi:
            self.intra.sendreceive(x, src=0, dst=idx)
        if saved is not None:
            x.copy_(saved)
        return x

    def allgather(self, x: torch.Tensor) -> torch.Tensor:
        """Gather in each group, over the roots, then fan out: a new flat
        tensor in (group, position) order."""
        part = self.intra.allgather(x)
        total = self.inter.allgather(part) if self.inter is not None else part
        # The other ranks learn the size before the payload.
        n = torch.tensor([total.numel() if self.is_root else 0])
        self.intra.broadcast(n, root=0)
        if not self.is_root:
            total = torch.empty(int(n[0]), dtype=x.dtype)
        self.intra.broadcast(total, root=0)
        return total

    def sendreceive(self, x: torch.Tensor, src: int,
                    dst: int) -> torch.Tensor:
        """``dst`` gets ``src``'s tensor through the hierarchy: to the
        source group's root, over the roots, to ``dst`` in its group.  Only
        ``dst``'s tensor changes."""
        gs, is_ = self._locate(src)
        gd, id_ = self._locate(dst)
        if gs == gd:
            if self.group_index == gs:
                self.intra.sendreceive(x, src=is_, dst=id_)
            return x
        mid_hop = (self.rank != dst
                   and ((self.group_index == gs and self.is_root and is_ != 0)
                        or (self.group_index == gd and self.is_root
                            and id_ != 0)))
        saved = x.clone() if mid_hop else None
        if self.group_index == gs and is_ != 0:
            self.intra.sendreceive(x, src=is_, dst=0)
        if self.inter is not None:
            self.inter.sendreceive(x, src=gs, dst=gd)
        if self.group_index == gd and id_ != 0:
            self.intra.sendreceive(x, src=0, dst=id_)
        if saved is not None:
            x.copy_(saved)
        return x

    def barrier(self) -> None:
        """Two laps in each group around one over the roots: nobody leaves
        before every group has entered."""
        self.intra.barrier()
        if self.inter is not None:
            self.inter.barrier()
        self.intra.barrier()
