"""Ring collectives: allreduce (B1), reduce-scatter (B2) and allgather (B3)
as hand-written CUDA kernels over staging memory shared between processes.

Counterpart of ``torchmpi_tpu/collectives/pallas_ring.py``.  Each process
is one rank and passes **its own tensor**; rank r's result is the JAX
package's row r.  The JAX kernels' schedule:

* reduce-scatter: p-1 steps; at step s rank ``me`` sends chunk
  ``(me - s - 1) mod p`` of its running partial to its right neighbour and
  adds the chunk arriving from its left into ``(me - s - 2) mod p``; rank
  ``me`` ends owning the reduced chunk ``me``;
* allgather: p-1 steps; at step s rank ``me`` forwards chunk
  ``(me - s) mod p`` and stores the arriving ``(me - s - 1) mod p``;
* allreduce: reduce-scatter then allgather, as one collective call.

So chunk c of the sum is ``x[(c+1) % p]``, then ``x[(c+j) % p] + acc`` for
j = 2..p, in the wire dtype (bf16 rounds after every add), with chunk c
covering the same elements as in JAX (``_geometry``): f32, bf16 and int32
results are bit-identical to the JAX package's.

The forms that compute it:

* the kernels (``ops/csrc/ring.cu``), for CUDA tensors, all three
  one-shot: each rank stages its input into its own slot (STAGE), waits
  once in the stream until every peer has staged, then either reduces
  every rank's slot in the order above straight into its output (REDUCE:
  B1, B2) or copies every rank's slot into its row of the output (GATHER:
  B3, any n, no padding).  Two launches and one stream wait a call.
  Staging and flag words are ``cudaMalloc``'d by the source, kept per
  (communicator, collective id), and mapped into every peer once through
  cudaIPC handles swapped over the communicator's process group;
* the per-rank CPU form, for CPU tensors: the ring's steps with
  ``torch.distributed`` send/recv of chunks over a gloo world;
* ``_ring_*_plain``: the whole ring's steps over a list of p tensors in one
  process, and ``_oneshot_*_plain``: the same results in the one-shot
  kernels' order (sums element by chunk; the gather as every rank's
  vector in rank order); the oracles of the tests and of ``chip_smoke.py``.

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
from .eager import _mean

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
    """Every rank's gather through the ring's steps: all ranks' vectors in
    rank order, (p n,).  The JAX kernel's lane padding is left out: a copy
    moves the same bits with or without it."""
    p, n = len(xs), xs[0].numel()
    outs = []
    for me, x in enumerate(xs):
        buf = torch.zeros((p, n), dtype=x.dtype, device=x.device)
        buf[me] = x.reshape(-1)
        outs.append(buf)
    _ag_steps_plain(outs)
    return [o.reshape(p * n) for o in outs]


def _oneshot_sum(xs: Sequence[torch.Tensor], lo: int, hi: int,
                 c: int) -> torch.Tensor:
    """Elements [lo, hi) of chunk c, summed over the ranks from rank
    (c+1) % p in the wire dtype, as the REDUCE kernel sums them."""
    p = len(xs)
    acc = xs[(c + 1) % p][lo:hi].clone()
    for j in range(2, p + 1):
        acc = xs[(c + j) % p][lo:hi] + acc
    return acc


def _oneshot_allreduce_plain(xs: Sequence[torch.Tensor],
                             mean: bool = False) -> List[torch.Tensor]:
    """Every rank's one-shot allreduce result (the same tensor for every
    rank): element i lies in chunk i // (rows * 128) of the ring's padded
    layout."""
    p, n = len(xs), xs[0].numel()
    flat = [x.reshape(-1) for x in xs]
    rows, _, _ = _geometry(n, p, xs[0].element_size())
    chunk = rows * _LANE
    out = torch.cat([_oneshot_sum(flat, c * chunk, min((c + 1) * chunk, n), c)
                     for c in range(p) if c * chunk < n] or [flat[0][:0]])
    return [_mean(out, p) if mean else out] * p


def _oneshot_reduce_scatter_plain(xs: Sequence[torch.Tensor]
                                  ) -> List[torch.Tensor]:
    """Every rank's one-shot reduce-scatter result: rank r sums chunk r,
    elements [r n/p, (r+1) n/p)."""
    p, n = len(xs), xs[0].numel()
    flat = [x.reshape(-1) for x in xs]
    m = n // p
    return [_oneshot_sum(flat, r * m, (r + 1) * m, r) for r in range(p)]


def _oneshot_allgather_plain(xs: Sequence[torch.Tensor]
                             ) -> List[torch.Tensor]:
    """Every rank's one-shot allgather result (the same tensor for every
    rank): every rank's vector in rank order, (p n,), as GATHER writes row
    r from rank r's slot."""
    out = torch.cat([x.reshape(-1) for x in xs])
    return [out] * len(xs)


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
        ll = ctypes.c_longlong
        sigs = {
            "tmpi_ring_alloc": [ctypes.c_size_t, ctypes.POINTER(vp)],
            "tmpi_ring_free": [vp],
            "tmpi_ring_host_alloc": [ctypes.c_size_t, ctypes.POINTER(vp)],
            "tmpi_ring_host_free": [vp],
            "tmpi_ring_ipc_get": [vp, ctypes.c_char_p],
            "tmpi_ring_ipc_open": [ctypes.c_char_p, ctypes.POINTER(vp)],
            "tmpi_ring_ipc_close": [vp],
            "tmpi_ring_ipc_handle_bytes": [],
            "tmpi_ring_flag_bytes": [],
            "tmpi_ring_read_flags": [vp, ctypes.POINTER(u64), i],
            "tmpi_ring_oneshot": [i, i, i, i, ll, ll, i, vp, vp, vp, vp, ll,
                                  u64, vp, vp],
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
    rank, mapped into every peer; ``seq`` counts this rank's calls on the
    state, so no flag is ever reset under a racing peer.  ``table`` lists
    every rank's block on the device (this rank's own at its rank), and
    ``status`` is a mapped host word that a REDUCE or GATHER sets when it
    finds a rank's error word set."""

    def __init__(self, comm: Communicator, cid: int, slot_bytes: int,
                 device: torch.device):
        lib = _library()
        self.comm, self.cid = comm, cid
        self.slot_bytes = slot_bytes
        self.seq = 0
        self.broken = False
        self.status = 0
        # One block: a page of flag words (error, ready, a block counter),
        # then two slots.
        self.flag_bytes = lib.tmpi_ring_flag_bytes()
        base = ctypes.c_void_p()
        _check_cuda(lib.tmpi_ring_alloc(self.flag_bytes + 2 * slot_bytes,
                                        ctypes.byref(base)),
                    "staging cudaMalloc")
        self.base = base.value
        self.peers: Dict[int, int] = {}
        try:
            status = ctypes.c_void_p()
            _check_cuda(lib.tmpi_ring_host_alloc(8, ctypes.byref(status)),
                        "cudaHostAlloc of the status word")
            self.status = status.value
            hb = lib.tmpi_ring_ipc_handle_bytes()
            handle = ctypes.create_string_buffer(hb)
            _check_cuda(lib.tmpi_ring_ipc_get(self.base, handle),
                        "cudaIpcGetMemHandle")
            import torch.distributed as dist

            handles: List[Optional[bytes]] = [None] * comm.size
            dist.all_gather_object(handles, handle.raw, group=comm.group)
            for r in range(comm.size):
                if r == comm.rank:
                    continue
                ptr = ctypes.c_void_p()
                _check_cuda(lib.tmpi_ring_ipc_open(handles[r],
                                                   ctypes.byref(ptr)),
                            f"cudaIpcOpenMemHandle of rank {r}")
                self.peers[r] = ptr.value
            self.table = torch.tensor([self.flags(r) for r in range(comm.size)],
                                      dtype=torch.int64, device=device)
        except BaseException:
            self.close()
            raise

    def flags(self, r: Optional[int] = None) -> int:
        """Device address of rank r's flags (this rank's by default)."""
        return self.base if r is None or r == self.comm.rank else self.peers[r]

    def flag_words(self) -> Tuple[int, int]:
        """This rank's (error, ready) words: whether the host gave up, and
        the peers' stages delivered."""
        out = (ctypes.c_uint64 * 2)()
        _check_cuda(_library().tmpi_ring_read_flags(self.base, out, 2),
                    "reading the ring's flags")
        return int(out[0]), int(out[1])

    def peer_gave_up(self) -> bool:
        """Whether a REDUCE or GATHER of this state found a rank's error
        word set (and so wrote nothing)."""
        return ctypes.c_uint64.from_address(self.status).value != 0

    def unmap(self) -> None:
        """Close the peers' mappings of this rank's view."""
        lib = _library()
        for ptr in self.peers.values():
            lib.tmpi_ring_ipc_close(ptr)
        self.peers = {}

    def free(self) -> None:
        lib = _library()
        if self.base:
            lib.tmpi_ring_free(self.base)
            self.base = 0
        if self.status:
            lib.tmpi_ring_host_free(self.status)
            self.status = 0

    def close(self) -> None:
        self.unmap()
        self.free()


_states: Dict[Tuple[int, Tuple[int, ...], int], _RingState] = {}


def _state(comm: Communicator, cid: int, slot_bytes: int,
           device: torch.device) -> _RingState:
    """The ring state of (comm, cid), made on first use and remade when a
    call needs larger slots.  A call's slot size is the same on every rank,
    so every rank remakes it at the same call; the stream is drained first,
    so no queued kernel still uses the old memory."""
    key = (id(comm), comm.ranks, cid)
    st = _states.get(key)
    if st is not None and st.slot_bytes < slot_bytes:
        _release([st], comm.group)
        st = None
    if st is None:
        st = _states[key] = _RingState(comm, cid, slot_bytes, device)
    return st


def _release(states: List[_RingState], group=None) -> None:
    """Free ``states`` on every rank of ``group`` together: each rank drains
    its stream, then all close their mappings of the peers' memory, then
    all free their own, so no rank frees memory a peer still maps or a
    queued kernel still uses."""
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


def _usable(st: _RingState) -> None:
    if st.broken:
        raise RingError(f"ring state of collective id {st.cid:#x} was given "
                        f"up on by an earlier call")


def _run_oneshot(kind: str, comm: Communicator, cid: int, x: torch.Tensor,
                 out: torch.Tensor, mean: bool) -> None:
    """One one-shot call of ``kind`` ('allreduce', 'reduce_scatter' or
    'allgather') on the current stream: ``x`` is this rank's contiguous
    (n,) input, ``out`` its (n,), (n/p,) or (p n,) result, divided by p
    when ``mean``.  Waits for the call to end; past ``RING_TIMEOUT_S`` it
    aborts the call and raises :class:`RingError`, as it does when a peer
    gave up on it."""
    p, me, n = comm.size, comm.rank, x.numel()
    slot_bytes = -(-max(n * x.element_size(), 1) // 256) * 256
    st = _state(comm, cid, slot_bytes, x.device)
    _usable(st)
    rows, _, _ = _geometry(n, p, x.element_size())
    lib = _library()
    k = st.seq
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        _check_cuda(lib.tmpi_ring_oneshot(
            _KINDS[kind], _DTYPE_CODES[x.dtype], p, me, n, rows * _LANE,
            int(mean), x.data_ptr(), out.data_ptr(), st.table.data_ptr(),
            st.base, st.slot_bytes, k, st.status, stream.cuda_stream),
            f"one-shot {kind} launch")
        st.seq += 1
        late = _await(st, stream)
    where = f"{kind} on rank {me} of {p} (collective id {cid:#x})"
    if late is None:
        if not st.peer_gave_up():
            return
        st.broken = True
        raise RingError(f"{where} raised: a peer had given up on call {k}")
    words, drained = late
    raise RingError(
        f"{where} gave up at call {k}: {max(words[1] - (p - 1) * k, 0)} of "
        f"{p - 1} peers had staged within {RING_TIMEOUT_S} s"
        + _undrained(drained))


def _await(st: _RingState, stream) -> Optional[Tuple[Tuple[int, ...], bool]]:
    """Wait for the call just enqueued on ``stream``: None once it is done.
    Past ``RING_TIMEOUT_S`` a peer did not arrive: the state is given up,
    this rank's queued waits are released (:func:`tmpi_ring_abort`) so its
    stream drains, and the result is the flag words read before the abort
    and whether the stream drained."""
    done = torch.cuda.Event()
    done.record(stream)
    if _wait(done, RING_TIMEOUT_S):
        return None
    words = st.flag_words()
    st.broken = True
    _check_cuda(_library().tmpi_ring_abort(st.flags()), "aborting the ring")
    return words, _wait(done, RING_TIMEOUT_S)


def _undrained(drained: bool) -> str:
    return "" if drained else ("; the stream did not drain after the abort "
                               "either, so this process's CUDA stream is "
                               "unusable")


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
    ranks of ``comm`` (default: the current communicator): each element
    summed in the order of its chunk of the ring's layout (zero-padded to
    ``p * rows * 128`` with ``rows`` from :func:`_geometry`) in the wire
    dtype, then divided by p when ``mean``.

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
    if x.device.type == "cpu":
        buf = _pad_ar(x, p)
        _rs_steps_cpu(c, buf)
        _ag_steps_cpu(c, buf)
        out = buf.reshape(-1)[:n]
        return _mean(out, p) if mean else out
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    folded = mean and x.dtype != torch.int32
    _run_oneshot("allreduce", c, _RS_COLLECTIVE_ID if collective_id is None
                 else collective_id, x.contiguous(), out, folded)
    _count("allreduce")
    return _mean(out, p) if mean and not folded else out


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
    me = comm.rank
    if x.device.type == "cpu":
        buf = _pad_rs(x, p)
        _rs_steps_cpu(comm, buf)
        return buf[me, :n // p].clone()
    out = torch.empty(n // p, dtype=x.dtype, device=x.device)
    _run_oneshot("reduce_scatter", comm, _RS_COLLECTIVE_ID, x.contiguous(),
                 out, False)
    _count("reduce_scatter")
    return out


def ring_allgather(comm: Communicator, x: torch.Tensor,
                   collective_id: Optional[int] = None) -> torch.Tensor:
    """Ring allgather of this rank's (n,) vector: every rank's vector in
    rank order, ``(p n,)``, for any n.  A ring that may be in flight beside
    the public one takes a ``collective_id`` of its own."""
    _check_tensor(x, "ring_allgather")
    p, n = comm.size, x.numel()
    if p == 1:
        return x
    if x.device.type == "cpu":
        out = torch.zeros((p, n), dtype=x.dtype)
        out[comm.rank] = x
        _ag_steps_cpu(comm, out)
        return out.reshape(p * n)
    out = torch.empty(p * n, dtype=x.dtype, device=x.device)
    _run_oneshot("allgather", comm, _AG_COLLECTIVE_ID if collective_id is None
                 else collective_id, x.contiguous(), out, False)
    _count("allgather")
    return out
