"""Continuous-batching inference engine: iteration-level scheduling.

The port's counterpart of ``torchmpi_tpu/serving/engine.py``: the same
scheduler (``ServeEngine``, ``Request``, ``StubRunner``, the typed shed
reasons) over a PyTorch :class:`LlamaRunner`.

Orca-style scheduler over a prefill/decode split runner: the decode
batch is re-assembled **every iteration** from whatever requests are
live, so requests join as soon as a slot and KV lease are available and
leave the moment they finish or shed — a long generation never blocks a
short one behind it (no head-of-line blocking).

Two runners implement the same contract:

- :class:`LlamaRunner` — the real path over ``models/llama``'s
  ``_prefill`` and decode primitives, extended here with per-slot decode
  positions (each slot of the batched step sits at its own sequence
  position — the continuous-batching requirement the generation-shaped
  ``_decode_step`` does not have).
- :class:`StubRunner` — deterministic tokens with optional simulated
  per-token latency (``serve_stub_token_s``), so load and chaos legs run
  on one host without a model in the loop.

KV accounting goes through :class:`~torchmpi_tpu_torch.serving.kvcache.BlockPool`:
admission leases blocks for the prompt, decode extends the lease one
token at a time, and lease-growth failure triggers deadline-aware
eviction before the request itself is shed (``reason=kv_pressure``).
"""
from __future__ import annotations

import collections
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..runtime import config
from . import serve_config
from .kvcache import BlockPool, PoolExhausted

# Request lifecycle states.
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
SHED = "shed"

# Typed shed/rejection reasons (the frontend maps these onto HTTP).
REASON_QUEUE_FULL = "queue_full"
REASON_KV_PRESSURE = "kv_pressure"
REASON_DEADLINE = "deadline"
REASON_DRAINING = "draining"


class AdmissionRejected(Exception):
    """Typed admission failure; ``reason`` is one of the REASON_* strings."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason
        self.detail = detail


@dataclass
class Request:
    """One generation request, from admission to completion/shed."""

    id: str
    prompt: List[int]
    max_new: int
    deadline: float                    # absolute, time.monotonic() seconds
    correlation: int = 0
    arrival: float = field(default_factory=time.monotonic)
    tokens: List[int] = field(default_factory=list)
    state: str = QUEUED
    shed_reason: str = ""
    slot: int = -1
    ttft_s: float = -1.0
    finished: float = -1.0
    done: threading.Event = field(default_factory=threading.Event)

    def latency_ms(self) -> float:
        end = self.finished if self.finished > 0 else time.monotonic()
        return (end - self.arrival) * 1000.0


class StubRunner:
    """Deterministic model runner for load/chaos legs: next token is a
    pure function of (prompt hash, position), optionally sleeping
    ``stub_token_s`` per iteration to emulate decode compute."""

    def __init__(self, slots: int, vocab: int = 256,
                 token_s: float = 0.0):
        self.slots = int(slots)
        self.vocab = int(vocab)
        self.token_s = float(token_s)
        self._seed = [0] * self.slots

    def prefill(self, slot: int, tokens: Sequence[int]) -> None:
        acc = len(tokens)
        for t in tokens:
            acc = (acc * 1000003 + int(t)) & 0x7FFFFFFF
        self._seed[slot] = acc
        if self.token_s > 0:
            # Prefill is one batched forward, not per-token decode cost.
            time.sleep(self.token_s)

    def decode(self, tokens: Sequence[int], pos: Sequence[int],
               active: Sequence[bool]) -> List[int]:
        if self.token_s > 0:
            time.sleep(self.token_s)
        out = []
        for s in range(self.slots):
            if active[s]:
                out.append((self._seed[s] + int(pos[s]) * 31) % self.vocab)
            else:
                out.append(0)
        return out


def _bucket_len(n: int, max_len: int, floor: int = 8) -> int:
    """Smallest power-of-two bucket >= ``n`` (capped at ``max_len``).

    Prefill pads the prompt to its bucket, as the JAX runner does to keep
    its compile cache at O(log max_len) graphs; the port keeps the same
    padding so both runners compute on the same shapes."""
    b = int(floor)
    while b < n:
        b *= 2
    return min(b, int(max_len))


class LlamaRunner:
    """Prefill/decode over ``models/llama`` with per-slot positions.

    The device cache is slot-strided ``(layers, slots, max_len, KV, hd)``
    and paging is host-side admission over this storage (the BlockPool).
    Prefill runs the batched ``_prefill`` (``attn="full"``, as in the JAX
    runner) into a slot's stripe; decode is one step over all slots where
    each slot writes its own position and reads the cache under a per-slot
    causal mask.  Parameters (f32, from ``rng_seed``) and cache live on
    ``device``: the current CUDA device unless the caller passes one.
    """

    def __init__(self, slots: int, cfg=None, rng_seed: int = 0,
                 max_len: int = 0, device=None):
        from ..models import llama

        self._llama = llama
        self.cfg = cfg if cfg is not None else llama.tiny()
        self.slots = int(slots)
        self.max_len = int(max_len) if max_len else self.cfg.max_seq
        self.device = llama.resolve_device(device)
        self.params = llama.init(rng_seed, self.cfg, device=self.device)
        self._cache = llama.init_kv_cache(self.cfg, self.slots, self.max_len,
                                          device=self.device)

    # -- runner contract ---------------------------------------------------
    def prefill(self, slot: int, tokens: Sequence[int]) -> None:
        """Seed one slot's cache stripe from its prompt."""
        import torch

        toks = list(tokens)
        # Pad to a power-of-two bucket.  Safe because prefill attention is
        # causal: pad positions never influence the prefix's K/V, and
        # decode's ``arange <= pos`` mask keeps each garbage pad entry
        # invisible until the generated token at that position overwrites
        # it (the cache write lands before the attention read).
        pad = _bucket_len(len(toks), self.max_len)
        toks += [0] * (pad - len(toks))
        prompt = torch.tensor([toks], dtype=torch.long, device=self.device)
        stripe = {"k": self._cache["k"][:, slot:slot + 1],
                  "v": self._cache["v"][:, slot:slot + 1]}
        # The JAX runner copies a whole fresh (zeroed) one-slot cache into
        # the stripe; zeroing the tail and prefilling the view in place
        # leaves the same stripe.
        stripe["k"][:, :, pad:] = 0
        stripe["v"][:, :, pad:] = 0
        self._llama._prefill(self.cfg, self.params, stripe, prompt,
                             attn="full")

    def decode(self, tokens: Sequence[int], pos: Sequence[int],
               active: Sequence[bool]) -> List[int]:
        """One decode position for every slot at its OWN position: rope
        angles per slot, cache write at ``pos[s]``, causal mask
        ``arange(max_len) <= pos[s]``.  Returns the greedy next tokens."""
        import torch

        llama, cfg = self._llama, self.cfg
        S = self.slots
        hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        scale = 1.0 / math.sqrt(hd)
        dev = self.device
        with torch.no_grad():
            t = torch.tensor(list(tokens), dtype=torch.long, device=dev)
            p = torch.tensor(list(pos), dtype=torch.long, device=dev)
            # Positions past the furthest slot are masked for every slot
            # (weight exactly 0), so the read stops there.
            T = max(int(x) for x in pos) + 1
            visible = torch.arange(T, device=dev)[None, :] <= p[:, None]
            cos, sin = llama._rope_angles(p, hd, cfg.rope_theta)
            cos, sin = cos[:, None, :], sin[:, None, :]   # (S, 1, hd/2)
            slots = torch.arange(S, device=dev)
            h = self.params["embed"][t]                     # (S, D)
            for i, lp in enumerate(llama._layers(self.params)):
                x = llama.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
                q = llama._rotate((x @ lp["wq"]).reshape(S, H, hd), cos, sin)
                k_new = llama._rotate((x @ lp["wk"]).reshape(S, KV, hd),
                                      cos, sin)
                v_new = (x @ lp["wv"]).reshape(S, KV, hd)
                ck, cv = self._cache["k"][i], self._cache["v"][i]
                # In place at [slot, pos[slot]]: the same cache as the JAX
                # runner's where(arange == pos) over the whole cache, with
                # one row written per slot instead of every row rewritten.
                ck[slots, p] = k_new.to(ck.dtype)
                cv[slots, p] = v_new.to(cv.dtype)
                o = llama._grouped_cache_attention(q, ck[:, :T], cv[:, :T],
                                                   visible, scale)
                h = h + o.to(h.dtype) @ lp["wo"]
                x = llama.rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
                g = torch.nn.functional.silu(x @ lp["w_gate"]) \
                    * (x @ lp["w_up"])
                h = h + g @ lp["w_down"]
            h = llama.rms_norm(h, self.params["norm"], cfg.norm_eps)
            logits = (h @ self.params["head"]).float()
            out = torch.argmax(logits, dim=-1).tolist()
        return [out[s] if active[s] else 0 for s in range(self.slots)]


def make_runner(cfg: Dict[str, Any], max_len: int = 0):
    """Build the runner ``serve_runner`` names (``stub`` | ``llama``)."""
    kind = cfg.get("runner", "stub")
    if kind == "llama":
        return LlamaRunner(cfg["max_batch"], max_len=max_len)
    if kind == "stub":
        return StubRunner(cfg["max_batch"],
                          token_s=cfg.get("stub_token_s", 0.0))
    raise ValueError(f"unknown serve_runner {kind!r}")


def _journal(kind: str, **data) -> None:
    from ..obs import journal as journal_mod

    journal_mod.emit(kind, **data)


class ServeEngine:
    """The iteration loop: admission, join/leave scheduling, decode.

    One background thread runs :meth:`iteration` continuously; the
    frontend's handler threads call :meth:`submit` (admission) and wait
    on each request's ``done`` event.  All scheduler state is guarded by
    one lock — the scheduler-vs-frontend interleaving is the race class
    the sanitize drill exercises.
    """

    def __init__(self, runner=None, pool: Optional[BlockPool] = None,
                 registry=None, cfg: Optional[Dict[str, Any]] = None):
        self.cfg = dict(cfg) if cfg is not None else serve_config()
        self.pool = pool if pool is not None else BlockPool(
            self.cfg["kv_blocks"], self.cfg["block_size"],
            registry=registry)
        self.runner = runner if runner is not None else make_runner(self.cfg)
        self.registry = registry
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: collections.Deque[Request] = collections.deque()
        self._slots: List[Optional[Request]] = [None] * self.runner.slots
        self._requests: Dict[str, Request] = {}
        self._latencies: collections.Deque[float] = collections.deque(
            maxlen=512)
        self._draining = False
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._iterations = 0
        self._tokens_window: collections.Deque[tuple] = collections.deque(
            maxlen=256)
        self._seq = 0

    # -- metrics helpers ---------------------------------------------------
    def _count_outcome(self, outcome: str) -> None:
        if self.registry is None:
            return
        self.registry.counter(
            "tmpi_serve_requests_total",
            "Serving requests by terminal outcome (done / shed_*)",
        ).inc(1, {"outcome": outcome})

    def _publish_gauges(self) -> None:
        if self.registry is None:
            return
        self.registry.gauge(
            "tmpi_serve_queue_depth",
            "Admitted requests waiting for a decode slot",
        ).set(float(len(self._queue)), {})
        self.registry.gauge(
            "tmpi_serve_active_slots",
            "Decode slots occupied this iteration",
        ).set(float(sum(1 for s in self._slots if s is not None)), {})

    def _publish_latency(self, req: Request) -> None:
        lat_ms = req.latency_ms()
        with self._lock:
            self._latencies.append(lat_ms)
            p99 = self._percentile(99.0)
        if self.registry is None:
            return
        outcome = req.state if req.state == DONE else f"shed_{req.shed_reason}"
        self.registry.histogram(
            "tmpi_serve_latency_seconds",
            "End-to-end request latency (admission to completion or shed)",
        ).observe(lat_ms / 1000.0, {"outcome": outcome})
        self.registry.gauge(
            "tmpi_serve_p99_ms",
            "p99 end-to-end request latency over the recent window (ms) — "
            "the serve_p99_over_deadline SLO rule watches this",
        ).set(p99, {})

    # -- public stats ------------------------------------------------------
    # The latency/throughput windows are scheduler state like everything
    # else: mutated and read under self._lock.  The ``_``-prefixed
    # internals assume the caller holds it (Lock is not reentrant).
    def _percentile(self, q: float) -> float:
        lats = sorted(self._latencies)
        if not lats:
            return 0.0
        idx = min(len(lats) - 1, int(round((q / 100.0) * (len(lats) - 1))))
        return lats[idx]

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._percentile(q)

    def _tokens_per_sec(self) -> float:
        win = list(self._tokens_window)
        if len(win) < 2:
            return 0.0
        dt = win[-1][0] - win[0][0]
        toks = sum(n for _, n in win[1:])
        return toks / dt if dt > 0 else 0.0

    def tokens_per_sec(self) -> float:
        with self._lock:
            return self._tokens_per_sec()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "queued": len(self._queue),
                "active": sum(1 for s in self._slots if s is not None),
                "slots": len(self._slots),
                "iterations": self._iterations,
                "draining": self._draining,
                "kv": self.pool.stats(),
                "p50_ms": self._percentile(50.0),
                "p99_ms": self._percentile(99.0),
                "tokens_per_sec": self._tokens_per_sec(),
            }

    # -- admission (frontend-facing) ---------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int = 0,
               deadline_ms: int = 0, correlation: int = 0,
               request_id: str = "") -> Request:
        """Admission control: queue-depth + KV-headroom gate.

        Raises :class:`AdmissionRejected` with a typed reason instead of
        buffering unboundedly — this is the backpressure surface.  On
        admission the request's KV lease (prompt + first block) is taken
        immediately so the headroom gate sees honest occupancy.
        """
        cfg = self.cfg
        # Floor at 1: a client-supplied negative survives the truthiness
        # default and min(), and len(tokens) >= -3 would "complete" the
        # request after its first token.
        max_new = max(1, min(int(max_new) or cfg["max_new_tokens"],
                             cfg["max_new_tokens"]))
        deadline_ms = int(deadline_ms) or cfg["default_deadline_ms"]
        now = time.monotonic()
        with self._lock:
            if self._stop or self._draining:
                raise AdmissionRejected(REASON_DRAINING,
                                        "replica is draining")
            if len(self._queue) >= cfg["max_queue"]:
                raise AdmissionRejected(
                    REASON_QUEUE_FULL,
                    f"queue at bound {cfg['max_queue']}")
            if self.pool.headroom() < cfg["admission_headroom"]:
                raise AdmissionRejected(
                    REASON_KV_PRESSURE,
                    f"KV headroom {self.pool.headroom():.3f} below gate "
                    f"{cfg['admission_headroom']}")
            self._seq += 1
            rid = request_id or f"r{self._seq}"
            req = Request(id=rid, prompt=list(prompt), max_new=max_new,
                          deadline=now + deadline_ms / 1000.0,
                          correlation=int(correlation))
            try:
                self.pool.allocate(rid, len(req.prompt) + 1,
                                   deadline=req.deadline)
            except PoolExhausted as e:
                raise AdmissionRejected(REASON_KV_PRESSURE, str(e)) from e
            self._requests[rid] = req
            self._queue.append(req)
            self._publish_gauges()
            self._wake.notify()
            return req

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServeEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="tmpi-serve-engine", daemon=True)
            self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting; wait for in-flight work to finish, then shed
        stragglers.  Returns True if everything finished inside the
        timeout (``serve_drain_timeout_s`` by default)."""
        if timeout is None:
            timeout = self.cfg["drain_timeout_s"]
        with self._lock:
            self._draining = True
            self._wake.notify()
        _journal("serve.drain", timeout_s=timeout)
        deadline = time.monotonic() + max(0.0, timeout)
        clean = True
        while time.monotonic() < deadline:
            with self._lock:
                live = list(self._queue) + [
                    s for s in self._slots if s is not None]
            if not live:
                break
            time.sleep(0.01)
        else:
            clean = False
        with self._lock:
            leftovers = list(self._queue) + [
                s for s in self._slots if s is not None]
        for req in leftovers:
            self._shed(req, REASON_DRAINING)
        return clean and not leftovers

    def undrain(self) -> None:
        with self._lock:
            self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._wake.notify()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- scheduling core ---------------------------------------------------
    def _shed(self, req: Request, reason: str) -> None:
        """Terminal shed: free the lease/slot, type the reason, count it."""
        with self._lock:
            if req.state in (DONE, SHED):
                return
            req.state = SHED
            req.shed_reason = reason
            req.finished = time.monotonic()
            if req.slot >= 0 and self._slots[req.slot] is req:
                self._slots[req.slot] = None
            try:
                self._queue.remove(req)
            except ValueError:
                pass
            self._requests.pop(req.id, None)
            self._publish_gauges()
        self.pool.release(req.id)
        self._count_outcome(f"shed_{reason}")
        self._publish_latency(req)
        _journal("serve.shed", request=req.id, reason=reason,
                      generated=len(req.tokens))
        self._record_request_span(req)
        req.done.set()

    def _complete(self, req: Request) -> None:
        with self._lock:
            req.state = DONE
            req.finished = time.monotonic()
            if req.slot >= 0 and self._slots[req.slot] is req:
                self._slots[req.slot] = None
            self._requests.pop(req.id, None)
            self._publish_gauges()
        self.pool.release(req.id)
        self._count_outcome("done")
        self._publish_latency(req)
        self._record_request_span(req)
        req.done.set()

    def _record_request_span(self, req: Request) -> None:
        """Per-request span carrying the frontend's correlation id — the
        join point between the request plane and the tracer."""
        if not config.get("obs_trace"):
            return
        from ..obs import tracer

        end = req.finished if req.finished > 0 else time.monotonic()
        base = time.time_ns() - int((end - req.arrival) * 1e9)
        tracer.record("serve.generate", base, time.time_ns(),
                      correlation=req.correlation, outcome=req.state,
                      reason=req.shed_reason, tokens=len(req.tokens))

    def _expire(self, now: float) -> None:
        """Deadline shed wherever the request is — queued or mid-decode."""
        expired = self.pool.evict_expired(now)
        with self._lock:
            victims = [r for r in list(self._queue) +
                       [s for s in self._slots if s is not None]
                       if r.deadline <= now or r.id in expired]
        if expired:
            _journal("serve.evict", requests=list(expired))
        for req in victims:
            self._shed(req, REASON_DEADLINE)

    def _join(self, now: float) -> None:
        """Move queued requests into free decode slots and prefill them."""
        while True:
            with self._lock:
                if not self._queue:
                    return
                free = [i for i, s in enumerate(self._slots) if s is None]
                if not free:
                    return
                req = self._queue.popleft()
                slot = free[0]
                req.slot = slot
                req.state = RUNNING
                self._slots[slot] = req
                self._publish_gauges()
            if config.get("obs_trace"):
                from ..obs import tracer

                with tracer.span("serve.prefill",
                                 correlation=req.correlation,
                                 request=req.id,
                                 prompt_tokens=len(req.prompt)):
                    self.runner.prefill(req.slot, req.prompt)
            else:
                self.runner.prefill(req.slot, req.prompt)

    def _decode_once(self, now: float) -> int:
        """One batched decode over the currently-active slots."""
        with self._lock:
            batch = list(self._slots)
        active = [r is not None for r in batch]
        if not any(active):
            return 0
        tokens, pos = [], []
        for r in batch:
            if r is None:
                tokens.append(0)
                pos.append(0)
            else:
                last = r.tokens[-1] if r.tokens else r.prompt[-1]
                tokens.append(int(last))
                pos.append(len(r.prompt) + len(r.tokens) - 1)
        nxt = self.runner.decode(tokens, pos, active)
        produced = 0
        for s, r in enumerate(batch):
            if r is None or r.state != RUNNING:
                continue
            try:
                self.pool.extend(r.id, 1)
            except KeyError:
                # The lease vanished out from under a running request
                # (evicted on behalf of another slot): shed it — an
                # uncaught KeyError here would kill the scheduler.
                self._shed(r, REASON_KV_PRESSURE)
                continue
            except PoolExhausted:
                # Deadline-aware eviction: reclaim from the request
                # closest to expiry before giving up on this one.  An
                # evicted victim no longer holds a lease, so it must
                # leave the engine NOW — a still-RUNNING (or queued)
                # victim would KeyError on its own next extend.
                for rid in self.pool.evict_for(1, now, protect=(r.id,)):
                    with self._lock:
                        victim = self._requests.get(rid)
                    if victim is not None:
                        self._shed(victim, REASON_KV_PRESSURE)
                try:
                    self.pool.extend(r.id, 1)
                except (PoolExhausted, KeyError):
                    self._shed(r, REASON_KV_PRESSURE)
                    continue
            if not r.tokens:
                r.ttft_s = time.monotonic() - r.arrival
            r.tokens.append(int(nxt[s]))
            produced += 1
            if len(r.tokens) >= r.max_new:
                self._complete(r)
        if produced and self.registry is not None:
            self.registry.counter(
                "tmpi_serve_tokens_total",
                "Tokens generated across all requests",
            ).inc(produced)
        with self._lock:
            self._tokens_window.append((time.monotonic(), produced))
        return produced

    def iteration(self) -> int:
        """One scheduler iteration: expire, join, decode.  Returns tokens
        produced.  Public so tests can single-step the scheduler."""
        now = time.monotonic()
        self._expire(now)
        self._join(now)
        produced = self._decode_once(now)
        with self._lock:
            self._iterations += 1
        return produced

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stop:
                    return
                idle = (not self._queue
                        and all(s is None for s in self._slots))
                if idle:
                    self._wake.wait(timeout=0.05)
                    if self._stop:
                        return
            try:
                self.iteration()
            except Exception as e:  # noqa: BLE001 - scheduler must survive
                # An unexpected error must not kill the daemon scheduler
                # silently — every in-flight and future request would
                # time out and the replica would never recover.  Count
                # it, journal it, back off briefly, keep scheduling.
                if self.registry is not None:
                    self.registry.counter(
                        "tmpi_serve_scheduler_errors_total",
                        "Unexpected exceptions survived by the serving "
                        "engine's iteration loop",
                    ).inc(1)
                _journal("serve.scheduler_error", error=repr(e))
                time.sleep(0.01)
