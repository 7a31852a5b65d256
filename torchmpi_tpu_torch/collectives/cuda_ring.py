"""Ring collectives: allreduce (B1), reduce-scatter (B2) and allgather (B3)
as hand-written CUDA kernels over staging memory shared between processes.

Counterpart of ``torchmpi_tpu/collectives/pallas_ring.py``.  Each process
is one rank and passes **its own tensor**; rank r's result is the JAX
package's row r.  The schedule is the JAX kernels', step for step:

* reduce-scatter: p-1 steps; at step s rank ``me`` sends chunk
  ``(me - s - 1) mod p`` of its running partial to its right neighbour and
  adds the chunk arriving from its left into ``(me - s - 2) mod p``; rank
  ``me`` ends owning the reduced chunk ``me``;
* allgather: p-1 steps; at step s rank ``me`` forwards chunk
  ``(me - s) mod p`` and stores the arriving ``(me - s - 1) mod p``;
* allreduce: reduce-scatter then allgather, as one collective call.

The running sum stays in the wire dtype (bf16 rounds after every add), and
chunk c covers the same elements as in JAX (``_geometry``), so f32, bf16 and
int32 results are bit-identical to the JAX package's.

Three forms compute that schedule:

* the kernels (``ops/csrc/ring.cu``), for CUDA tensors.  Staging slots and
  flag words are ``cudaMalloc``'d by the source, kept per (communicator,
  collective id), and mapped into the neighbours once through cudaIPC
  handles swapped over the communicator's process group;
* the per-rank CPU form, for CPU tensors: the same steps with
  ``torch.distributed`` send/recv of chunks over a gloo world;
* ``_ring_*_plain``: the whole ring over a list of p tensors in one
  process, the oracle of the tests and of ``chip_smoke.py``.

A CUDA tensor goes to the kernels or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..runtime import config
from ..runtime.communicator import Communicator

_LANE = 128
# Collective ids: one per ring that may be in flight at once.  The engine
# rotates CALLER_COLLECTIVE_ID_BASE + n % 8 over its gradient rings; the
# public reduce-scatter and allgather take their own ids, as in JAX.
_RS_COLLECTIVE_ID = 0x52
_AG_COLLECTIVE_ID = 0x53
CALLER_COLLECTIVE_ID_BASE = 0x60
# Seconds a ring call may take before the host gives up on it and raises.
RING_TIMEOUT_S = 10.0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_KINDS = {"allreduce": 0, "reduce_scatter": 1, "allgather": 2}

# Kernel launches in this process, one per collective call (the plain and
# CPU forms do not count); chip_smoke.py reads them.
ring_allreduce_launches = 0
ring_reduce_scatter_launches = 0
ring_allgather_launches = 0


class RingError(RuntimeError):
    """A ring did not complete: a neighbour never arrived within the
    deadline, or a CUDA call failed."""


# --------------------------------------------------------------- geometry

def _geometry(n: int, p: int, itemsize: int) -> Tuple[int, int, int]:
    """(rows, q, subrows): lanes of 128 per chunk, sub-chunks per step and
    rows per sub-chunk, from the buffer knobs; the JAX package's rule."""
    per_chunk = math.ceil(n / p) if n else 1
    rows = max(1, math.ceil(per_chunk / _LANE))
    chunk_bytes = rows * _LANE * itemsize
    max_buf = max(int(config.get("max_buffer_size")), _LANE * itemsize)
    min_buf = max(int(config.get("min_buffer_size")), _LANE * itemsize)
    target = min(max(min_buf, min(chunk_bytes, max_buf)), max_buf)
    q = max(1, math.ceil(chunk_bytes / target))
    subrows = math.ceil(rows / q)
    rows = subrows * q
    return rows, q, subrows


def _nslots(p: int) -> int:
    cap = int(config.get("max_num_buffers_per_collective_tpu"))
    return max(1, min(int(config.get("num_buffers_per_collective")), cap,
                      2 * (p - 1)))


# ------------------------------------------------------------ plain forms

def _rs_steps_plain(accs: List[torch.Tensor]) -> None:
    """Reduce-scatter steps over every rank's (p, chunk) partials, in
    place."""
    p = len(accs)
    for s in range(p - 1):
        sent = [accs[me][(me - s - 1) % p].clone() for me in range(p)]
        for me in range(p):
            r = (me - s - 2) % p
            accs[me][r] = accs[me][r] + sent[(me - 1) % p]


def _ag_steps_plain(outs: List[torch.Tensor]) -> None:
    """Allgather steps over every rank's (p, chunk) buffer, in place."""
    p = len(outs)
    for s in range(p - 1):
        sent = [outs[me][(me - s) % p].clone() for me in range(p)]
        for me in range(p):
            outs[me][(me - s - 1) % p] = sent[(me - 1) % p]


def _pad_ar(x: torch.Tensor, p: int) -> torch.Tensor:
    """Flat (n,) zero-padded to (p, rows * 128): chunk c is row c."""
    rows, _, _ = _geometry(x.numel(), p, x.element_size())
    flat = torch.zeros(p * rows * _LANE, dtype=x.dtype, device=x.device)
    flat[:x.numel()] = x
    return flat.view(p, rows * _LANE)


def _pad_rs(x: torch.Tensor, p: int) -> torch.Tensor:
    """Flat (n,) as p chunks of n/p, each lane-padded on its own."""
    n = x.numel()
    rows, _, _ = _geometry(n, p, x.element_size())
    chunks = torch.zeros((p, rows * _LANE), dtype=x.dtype, device=x.device)
    chunks[:, :n // p] = x.view(p, n // p)
    return chunks


def _pad_ag(x: torch.Tensor) -> torch.Tensor:
    """Flat (n,) lane-padded to one chunk."""
    rows, _, _ = _geometry(x.numel(), 1, x.element_size())
    chunk = torch.zeros(rows * _LANE, dtype=x.dtype, device=x.device)
    chunk[:x.numel()] = x
    return chunk


def _mean(out: torch.Tensor, p: int) -> torch.Tensor:
    """The replica mean, divided in the wire dtype as JAX does (an integer
    vector divides to f32, as ``int / int`` does there)."""
    return out / torch.tensor(p, dtype=out.dtype, device=out.device)


def _ring_allreduce_plain(xs: Sequence[torch.Tensor],
                          mean: bool = False) -> List[torch.Tensor]:
    """Every rank's allreduce result, the whole ring in this process."""
    p, n = len(xs), xs[0].numel()
    bufs = [_pad_ar(x.reshape(-1), p) for x in xs]
    _rs_steps_plain(bufs)
    _ag_steps_plain(bufs)
    outs = [b.reshape(-1)[:n] for b in bufs]
    return [_mean(o, p) for o in outs] if mean else outs


def _ring_reduce_scatter_plain(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's reduced chunk: rank r gets elements [r n/p, (r+1) n/p)
    of the sum."""
    p, n = len(xs), xs[0].numel()
    bufs = [_pad_rs(x.reshape(-1), p) for x in xs]
    _rs_steps_plain(bufs)
    return [bufs[me][me, :n // p].clone() for me in range(p)]


def _ring_allgather_plain(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's gather: all ranks' vectors in rank order, (p n,)."""
    p, n = len(xs), xs[0].numel()
    outs = []
    for me, x in enumerate(xs):
        buf = torch.zeros((p, _pad_ag(x.reshape(-1)).numel()), dtype=x.dtype,
                          device=x.device)
        buf[me] = _pad_ag(x.reshape(-1))
        outs.append(buf)
    _ag_steps_plain(outs)
    return [o[:, :n].reshape(p * n) for o in outs]


# ------------------------------------------------------ per-rank CPU form

def _exchange(comm: Communicator, send: torch.Tensor,
              recv: torch.Tensor) -> None:
    """Send ``send`` to the right neighbour and receive ``recv`` from the
    left one, over the communicator's process group."""
    import torch.distributed as dist

    me, p = comm.rank, comm.size
    req = dist.isend(send, dst=comm.global_rank((me + 1) % p),
                     group=comm.group)
    dist.recv(recv, src=comm.global_rank((me - 1) % p), group=comm.group)
    req.wait()


def _rs_steps_cpu(comm: Communicator, acc: torch.Tensor) -> None:
    me, p = comm.rank, comm.size
    recv = torch.empty_like(acc[0])
    for s in range(p - 1):
        _exchange(comm, acc[(me - s - 1) % p].clone(), recv)
        r = (me - s - 2) % p
        acc[r] = acc[r] + recv


def _ag_steps_cpu(comm: Communicator, out: torch.Tensor) -> None:
    me, p = comm.rank, comm.size
    recv = torch.empty_like(out[0])
    for s in range(p - 1):
        _exchange(comm, out[(me - s) % p].clone(), recv)
        out[(me - s - 1) % p] = recv


# ------------------------------------------------------------ kernel form

_lib = None


def _library():
    """The built ``ring.cu``, with every entry point's types declared."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("ring")
        vp, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
        sigs = {
            "tmpi_ring_alloc": [ctypes.c_size_t, ctypes.POINTER(vp)],
            "tmpi_ring_free": [vp],
            "tmpi_ring_ipc_get": [vp, ctypes.c_char_p],
            "tmpi_ring_ipc_open": [ctypes.c_char_p, ctypes.POINTER(vp)],
            "tmpi_ring_ipc_close": [vp],
            "tmpi_ring_ipc_handle_bytes": [],
            "tmpi_ring_flag_bytes": [],
            "tmpi_ring_read_flags": [vp, ctypes.POINTER(u64), i],
            "tmpi_ring_run": [i, i, i, i, ctypes.c_longlong, i, vp, vp,
                              vp, vp, vp, vp, vp, u64, vp],
            "tmpi_ring_abort": [vp],
        }
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
        _lib = lib
    return _lib


def _check_cuda(err: int, what: str) -> None:
    if err != 0:
        raise RingError(f"{what} failed: CUDA error {err}")


class _RingState:
    """Staging slots and flags of one (communicator, collective id) on this
    rank, mapped into both neighbours; ``seq`` counts this rank's sends on
    the ring over every call, so no flag is ever reset under a racing
    peer."""

    def __init__(self, comm: Communicator, cid: int, slot_bytes: int,
                 nslots: int):
        lib = _library()
        self.comm, self.cid = comm, cid
        self.slot_bytes, self.nslots = slot_bytes, nslots
        self.seq = 0
        self.broken = False
        # One block: a page of flag words (error, data, credit and a block
        # counter), then the slots.
        self.flag_bytes = lib.tmpi_ring_flag_bytes()
        base = ctypes.c_void_p()
        _check_cuda(lib.tmpi_ring_alloc(self.flag_bytes + nslots * slot_bytes,
                                        ctypes.byref(base)),
                    "staging cudaMalloc")
        self.base = base.value
        self.peers: Dict[int, int] = {}
        try:
            hb = lib.tmpi_ring_ipc_handle_bytes()
            handle = ctypes.create_string_buffer(hb)
            _check_cuda(lib.tmpi_ring_ipc_get(self.base, handle),
                        "cudaIpcGetMemHandle")
            import torch.distributed as dist

            handles: List[Optional[bytes]] = [None] * comm.size
            dist.all_gather_object(handles, handle.raw, group=comm.group)
            me, p = comm.rank, comm.size
            for r in {(me - 1) % p, (me + 1) % p} - {me}:
                ptr = ctypes.c_void_p()
                _check_cuda(lib.tmpi_ring_ipc_open(handles[r],
                                                   ctypes.byref(ptr)),
                            f"cudaIpcOpenMemHandle of rank {r}")
                self.peers[r] = ptr.value
        except BaseException:
            self.close()
            raise

    def flags(self, r: Optional[int] = None) -> int:
        """Device address of rank r's flags (this rank's by default)."""
        return self.base if r is None or r == self.comm.rank else self.peers[r]

    def slots(self, r: Optional[int] = None) -> int:
        return self.flags(r) + self.flag_bytes

    def flag_words(self) -> Tuple[int, int, int]:
        """This rank's (error, data, credit) words: whether the host gave
        up, the chunks delivered into its slots and its sends consumed."""
        out = (ctypes.c_uint64 * 3)()
        _check_cuda(_library().tmpi_ring_read_flags(self.base, out, 3),
                    "reading the ring's flags")
        return int(out[0]), int(out[1]), int(out[2])

    def unmap(self) -> None:
        """Close the neighbours' mappings of this rank's view."""
        lib = _library()
        for ptr in self.peers.values():
            lib.tmpi_ring_ipc_close(ptr)
        self.peers = {}

    def free(self) -> None:
        if self.base:
            _library().tmpi_ring_free(self.base)
            self.base = 0

    def close(self) -> None:
        self.unmap()
        self.free()


_states: Dict[Tuple[int, Tuple[int, ...], int], _RingState] = {}


def _state(comm: Communicator, cid: int, slot_bytes: int,
           nslots: int) -> _RingState:
    """The ring state of (comm, cid), made on first use and remade when a
    call needs larger slots or another slot count.  Both are the same on
    every rank for the same call, so every rank remakes it at the same
    call; the stream is drained first, so no queued step still uses the
    old memory."""
    key = (id(comm), comm.ranks, cid)
    st = _states.get(key)
    if st is not None and (st.slot_bytes < slot_bytes or st.nslots != nslots):
        _release([st], comm.group)
        st = None
    if st is None:
        st = _states[key] = _RingState(comm, cid, slot_bytes, nslots)
    return st


def _release(states: List[_RingState], group=None) -> None:
    """Free ``states`` on every rank of ``group`` together: each rank drains
    its stream, then all close their mappings of the neighbours' memory,
    then all free their own, so no rank frees memory a peer still maps or
    a queued step still uses."""
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier(group=group)
    for st in states:
        st.unmap()
    dist.barrier(group=group)
    for st in states:
        st.free()


def release_all() -> None:
    """Free every ring state of this process; collective over the world
    (``lifecycle.stop`` calls it on every rank)."""
    if _states:
        _release(list(_states.values()))
    _states.clear()


def _run_kernel(kind: str, comm: Communicator, cid: int, src: torch.Tensor,
                out: torch.Tensor, chunk: int) -> None:
    """One collective call of ``kind`` on the current stream: ``src`` is
    this rank's (p, chunk) block (allreduce, reduce-scatter) or its one
    chunk (allgather); ``out`` is (p, chunk).  Waits for the call to end;
    past ``RING_TIMEOUT_S`` it aborts the call and raises
    :class:`RingError`."""
    p, me = comm.size, comm.rank
    nslots = _nslots(p)
    st = _state(comm, cid, chunk * src.element_size(), nslots)
    if st.broken:
        raise RingError(f"ring state of collective id {cid:#x} was given up "
                        f"on by an earlier call")
    steps = {"allreduce": 2 * (p - 1), "reduce_scatter": p - 1,
             "allgather": p - 1}[kind]
    lib = _library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device)
        _check_cuda(lib.tmpi_ring_run(
            _KINDS[kind], _DTYPE_CODES[src.dtype], p, me, chunk, nslots,
            src.data_ptr(), out.data_ptr(), st.slots(),
            st.slots((me + 1) % p), st.flags(), st.flags((me + 1) % p),
            st.flags((me - 1) % p), st.seq, stream.cuda_stream),
            f"ring {kind} launch")
        base, st.seq = st.seq, st.seq + steps
        done = torch.cuda.Event()
        done.record(stream)
        if _wait(done, RING_TIMEOUT_S):
            return
        # A neighbour did not arrive: release this rank's queued waits so
        # its stream drains, then raise.
        received = st.flag_words()[1] - base
        st.broken = True
        _check_cuda(lib.tmpi_ring_abort(st.flags()), "aborting the ring")
        drained = _wait(done, RING_TIMEOUT_S)
    raise RingError(
        f"ring {kind} on rank {me} of {p} (collective id {cid:#x}) gave up "
        f"at step {min(received, steps - 1)} of {steps}: a neighbour did "
        f"not arrive within {RING_TIMEOUT_S} s"
        + ("" if drained else "; the stream did not drain after the abort "
           "either, so this process's CUDA stream is unusable"))


def _wait(event: torch.cuda.Event, seconds: float) -> bool:
    """Poll ``event`` until it completes (True) or ``seconds`` pass
    (False)."""
    deadline = time.monotonic() + seconds
    while not event.query():
        if time.monotonic() > deadline:
            return False
        time.sleep(2e-5)
    return True


def _count(kind: str) -> None:
    global ring_allreduce_launches, ring_reduce_scatter_launches
    global ring_allgather_launches
    if kind == "allreduce":
        ring_allreduce_launches += 1
    elif kind == "reduce_scatter":
        ring_reduce_scatter_launches += 1
    else:
        ring_allgather_launches += 1


def _check_tensor(x: torch.Tensor, what: str) -> None:
    if x.ndim != 1:
        raise ValueError(f"{what} expects this rank's flat (n,) vector, got "
                         f"shape {tuple(x.shape)}")
    if x.device.type == "cuda" and x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: the ring kernels take float32, bfloat16 "
                        f"and int32, got {x.dtype}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _comm_of(comm: Optional[Communicator]) -> Communicator:
    if comm is not None:
        return comm
    from ..runtime.communicator import stack

    return stack.current()


# -------------------------------------------------------------- public API

def inner_ring_allreduce(x: torch.Tensor, p: int, mean: bool = False,
                         collective_id: Optional[int] = None,
                         comm: Optional[Communicator] = None) -> torch.Tensor:
    """Ring-allreduce this rank's flat vector ``x`` ``(n,)`` over the ``p``
    ranks of ``comm`` (default: the current communicator): zero-padded to
    ``p * rows * 128`` with ``rows`` from :func:`_geometry`, reduced in the
    wire dtype, then divided by p when ``mean``.

    Rings that may be in flight together take distinct ``collective_id`` s
    (see :data:`CALLER_COLLECTIVE_ID_BASE`): each id has its own staging
    slots and flags."""
    _check_tensor(x, "inner_ring_allreduce")
    if p == 1:
        return x
    c = _comm_of(comm)
    if c.size != p:
        raise ValueError(f"p={p} but the communicator has {c.size} ranks")
    n = x.numel()
    buf = _pad_ar(x, p)
    if x.device.type == "cpu":
        _rs_steps_cpu(c, buf)
        _ag_steps_cpu(c, buf)
        out = buf
    else:
        out = torch.empty_like(buf)
        _run_kernel("allreduce", c, _RS_COLLECTIVE_ID if collective_id is None
                    else collective_id, buf, out, buf.shape[1])
        _count("allreduce")
    out = out.reshape(-1)[:n]
    return _mean(out, p) if mean else out


def ring_allreduce(comm: Communicator, x: torch.Tensor,
                   op: str = "sum") -> torch.Tensor:
    """Ring allreduce of this rank's (n,) vector, ``op`` 'sum' or 'mean'
    (the rings reduce with sum; mean is the folded divide)."""
    _check_tensor(x, "ring_allreduce")
    if op not in ("sum", "mean"):
        raise ValueError("ring collectives support op='sum'/'mean' only")
    if comm.size == 1:
        return x
    return inner_ring_allreduce(x, comm.size, mean=op == "mean", comm=comm)


def ring_reduce_scatter(comm: Communicator, x: torch.Tensor,
                        op: str = "sum") -> torch.Tensor:
    """Ring reduce-scatter of this rank's (n,) vector: rank r gets the r-th
    of the p equal parts of the sum, ``(n/p,)``."""
    _check_tensor(x, "ring_reduce_scatter")
    if op != "sum":
        raise ValueError("ring collectives support op='sum' only")
    p, n = comm.size, x.numel()
    if n % p != 0:
        raise ValueError(f"reduce_scatter data axis {n} not divisible by {p}")
    if p == 1:
        return x
    buf = _pad_rs(x, p)
    me = comm.rank
    if x.device.type == "cpu":
        _rs_steps_cpu(comm, buf)
        return buf[me, :n // p].clone()
    out = torch.empty_like(buf)
    _run_kernel("reduce_scatter", comm, _RS_COLLECTIVE_ID, buf, out,
                buf.shape[1])
    _count("reduce_scatter")
    return out[me, :n // p]


def ring_allgather(comm: Communicator, x: torch.Tensor) -> torch.Tensor:
    """Ring allgather of this rank's (n,) vector: every rank's vector in
    rank order, ``(p n,)``."""
    _check_tensor(x, "ring_allgather")
    p, n = comm.size, x.numel()
    if p == 1:
        return x
    chunk = _pad_ag(x)
    me = comm.rank
    if x.device.type == "cpu":
        out = torch.zeros((p, chunk.numel()), dtype=x.dtype)
        out[me] = chunk
        _ag_steps_cpu(comm, out)
    else:
        out = torch.empty((p, chunk.numel()), dtype=x.dtype, device=x.device)
        _run_kernel("allgather", comm, _AG_COLLECTIVE_ID, chunk, out,
                    chunk.numel())
        _count("allgather")
    return out[:, :n].reshape(p * n)
