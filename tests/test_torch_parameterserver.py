"""The port's parameter server (``parameterserver/``, its own build of
``_native/ps.cpp``) against the JAX package's, in one process: each
package loads its own library, so a "JAX server" and a "port server" are
two engines behind distinct loopback endpoints.

* ``get_range`` and ``PlacementRing`` owners, backups and shrunk rings
  equal JAX's key for key;
* a mixed cluster both ways — a JAX client on the port's servers and a
  port client on JAX's — leaves shards equal, byte for byte, to a cluster
  of one package, over the same pushes (f32 and bf16);
* every ``send`` rule and the wire dtypes against numpy's algebra;
* ``DownpourUpdate`` and ``EASGDUpdate`` against JAX's on the same
  gradients: the shards bit for bit, the parameters too;
* the fast durability, failover and replication cases of JAX's
  ``test_ps_failover.py`` and ``test_ps_replication.py`` (snapshots, the
  epoch fence, the add replay, failover, promotion, handoff), as cases of
  one parametrised test, with the flight recorder on for the promotion.

Servers run in-process with short deadlines (``ps_request_deadline_ms``
2000-4000, failover backoffs of 10-20 ms).
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch import parameterserver as tps
from torchmpi_tpu_torch.parameterserver import native as tnative
from torchmpi_tpu_torch.parameterserver.placement import PlacementRing
from torchmpi_tpu_torch.parameterserver.update import (DownpourUpdate,
                                                       EASGDUpdate)
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime.failure import PSFenceError, PSTransportError

F32 = 0
FAST = dict(ps_retry_max=2, ps_retry_backoff_ms=10,
            ps_request_deadline_ms=4000, ps_failover_max=6,
            ps_failover_backoff_ms=20)


def _jps():
    from torchmpi_tpu import parameterserver as jps

    return jps


@pytest.fixture()
def clean():
    """Fresh client state and knobs of both packages around a test."""
    from torchmpi_tpu.parameterserver import native as jnative
    from torchmpi_tpu.runtime import config as jconfig

    tps.shutdown()
    _jps().shutdown()
    yield
    tps.shutdown()
    _jps().shutdown()
    tconfig.reset()
    tnative.apply_config()
    jconfig.reset()
    jnative.apply_config()


def _servers(native_mod, n):
    L = native_mod.lib()
    sids = [L.tmpi_ps_server_start(0) for _ in range(n)]
    assert all(s > 0 for s in sids)
    return sids, [("127.0.0.1", L.tmpi_ps_server_port(s)) for s in sids]


# ---------------------------------------------------------------- placement

def test_get_range_matches_jax():
    jps = _jps()
    for total in (0, 1, 2, 7, 10, 63, 1000):
        for n in (1, 2, 3, 4, 7):
            for k in range(n):
                assert tps.get_range(total, n, k) == jps.get_range(total,
                                                                   n, k)
    with pytest.raises(ValueError):
        tps.get_range(8, 4, 4)


@pytest.mark.parametrize("slots,vnodes", [(3, 128), (5, 16), (1, 8)])
def test_placement_ring_matches_jax(slots, vnodes):
    from torchmpi_tpu.parameterserver.placement import PlacementRing as JRing

    mine, theirs = PlacementRing(range(slots), vnodes), JRing(range(slots),
                                                             vnodes)
    keys = [f"{i}/{k}" for i in range(1, 40) for k in range(4)]
    assert [mine.owner_backup(k) for k in keys] == \
        [theirs.owner_backup(k) for k in keys]
    if slots > 1:
        assert mine.without(0).assignment(keys) == \
            theirs.without(0).assignment(keys)
    assert mine.with_slot(slots).load(keys) == theirs.with_slot(slots).load(
        keys)


# ------------------------------------------------------------ mixed cluster

def _ops(client, dtype):
    """One sequence of registrations and pushes through a client module;
    returns every tensor's final shard bytes (pulled)."""
    vals = np.arange(37, dtype=np.float32) * 0.37 - 5.0
    adds = [np.linspace(-1, 1, 37, dtype=np.float32) * (r + 1)
            for r in range(3)]
    conv = ((lambda a: torch.from_numpy(a).to(dtype)) if client is tps
            else (lambda a: a.astype(dtype)))
    t = client.init(conv(vals))
    for a in adds:
        client.send(t, conv(a), rule="add").wait()
    z = client.init(conv(vals), initial="zero")
    client.send(z, conv(adds[0]), rule="copy").wait()
    client.send(z, conv(adds[1]), rule="add").wait()
    out = []
    for x in (t, z):
        h, buf = client.receive(x)
        h.wait()
        raw = buf.view(torch.int16 if dtype == torch.bfloat16 else
                       torch.int32).numpy() if client is tps else buf
        out.append(np.asarray(raw).tobytes())
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mixed_cluster_both_ways(clean, dtype):
    import ml_dtypes

    from torchmpi_tpu.parameterserver import native as jnative

    jps = _jps()
    tdt = getattr(torch, dtype)
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    # A JAX client on the port's servers.
    _, eps = _servers(tnative, 2)
    jps.init_cluster(endpoints=eps, start_server=False)
    jax_on_port = _ops(jps, jdt)
    jps.shutdown()
    tps.shutdown()
    # A port client on JAX's servers.
    _, eps = _servers(jnative, 2)
    tps.init_cluster(endpoints=eps, start_server=False)
    port_on_jax = _ops(tps, tdt)
    tps.shutdown()
    jps.shutdown()
    # One package throughout.
    _, eps = _servers(tnative, 2)
    tps.init_cluster(endpoints=eps, start_server=False)
    port_only = _ops(tps, tdt)
    assert jax_on_port == port_on_jax == port_only


# -------------------------------------------------------------------- rules

@pytest.fixture()
def cluster4(clean):
    _, eps = _servers(tnative, 4)
    tps.init_cluster(endpoints=eps, start_server=False)
    return eps


@pytest.mark.parametrize("rule", ["zero", "copy", "add"])
def test_send_rules(cluster4, rule):
    base = np.arange(11, dtype=np.float32)
    val = np.full(11, 2.5, np.float32)
    t = tps.init(base)
    tps.send(t, torch.from_numpy(val), rule=rule).wait()
    h, out = tps.receive(t)
    assert h.wait() is out
    want = {"zero": np.zeros(11), "copy": val, "add": base + val}[rule]
    np.testing.assert_array_equal(out.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", ["int64", "float16", "int8", "bfloat16",
                                   "float64"])
def test_wire_dtypes(cluster4, dtype):
    dt = getattr(torch, dtype)
    base = torch.arange(-6, 7).to(dt)
    t = tps.init(base)
    assert t.dtype == dt
    tps.send(t, torch.full((13,), 3).to(dt), rule="add").wait()
    h, out = tps.receive(t)
    h.wait()
    assert out.dtype == dt
    np.testing.assert_array_equal(out.double().numpy(),
                                  (base.double() + 3).numpy())


def test_tree_helpers_and_card_tensor_refused(cluster4):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3)}
    ts = tps.init_tensors(tree)
    out = tps.integrate_tensors(tps.prefetch_tensors(ts), tree)
    assert torch.equal(out["w"], tree["w"]) and torch.equal(out["b"],
                                                            tree["b"])
    with pytest.raises(ValueError):
        tps.send(ts[0], torch.ones(5))
    meta = torch.ones(6, device="meta")
    with pytest.raises(ValueError, match="host"):
        tps.send(ts[0], meta)


def test_native_trace_ring_drains_ps_events(cluster4):
    """``obs/native.py`` on the port's own engine: with ``obs_trace`` on,
    a push and a pull leave their phase events in the ring, stamped with
    the span's correlation id; the record layout and the op and phase
    names are JAX's."""
    from torchmpi_tpu.obs import native as jobs
    from torchmpi_tpu_torch.obs import native as tobs
    from torchmpi_tpu_torch.obs import tracer

    assert tobs.EVENT_DTYPE == jobs.EVENT_DTYPE
    assert (tobs.PS_OPS, tobs.HC_OPS, tobs.PHASES) == (jobs.PS_OPS,
                                                      jobs.HC_OPS,
                                                      jobs.PHASES)
    assert tobs.loaded("ps")
    tconfig.set("obs_trace", True)
    tobs.apply_config()
    try:
        tobs.drain_events("ps")
        t = tps.init(np.ones(9, np.float32))
        tps.send(t, np.ones(9, np.float32)).wait()
        h, _ = tps.receive(t)
        h.wait()
        rows = tobs.events_to_rows(tobs.drain_events("ps"))
    finally:
        tconfig.set("obs_trace", False)
        tobs.apply_config()
    ops = {(r["op"], r["phase"]) for r in rows}
    assert {("push", "complete"), ("pull", "complete")} <= ops, ops
    assert all(r["correlation"] for r in rows if r["op"] == "push")
    assert any(sp["name"] == "ps.send.e2e" for sp in tracer.drain())


# ---------------------------------------------------------- update drivers

def _drive(upd_cls, kw, package, steps=13, lr=0.1):
    """Run an update driver of ``package`` on a fixed gradient sequence;
    returns (final params, pulled shards) as numpy."""
    rng = np.random.RandomState(5)
    grads = [{"b": rng.randn(7).astype(np.float32),
              "w": rng.randn(3, 7).astype(np.float32)} for _ in range(steps)]
    init = {"b": np.zeros(7, np.float32),
            "w": rng.randn(3, 7).astype(np.float32)}
    if package == "jax":
        import jax.numpy as jnp

        params = {k: jnp.asarray(v) for k, v in init.items()}
        upd = upd_cls(**kw)
        for s, g in enumerate(grads):
            g = {k: jnp.asarray(v) for k, v in g.items()}
            params = {k: params[k] - lr * g[k] for k in params}
            params = upd.update(params, g, s)
        params = upd.flush(params)
        jps = _jps()
        center = jps.integrate_tensors(jps.prefetch_tensors(upd.tensors),
                                       params)
        return ({k: np.asarray(v) for k, v in params.items()},
                {k: np.asarray(v) for k, v in center.items()})
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    upd = upd_cls(**kw)
    for s, g in enumerate(grads):
        g = {k: torch.from_numpy(v) for k, v in g.items()}
        with torch.no_grad():
            for k in params:
                params[k].sub_(g[k] * lr)
        params = upd.update(params, g, s)
    params = upd.flush(params)
    center = tps.integrate_tensors(tps.prefetch_tensors(upd.tensors), params)
    return ({k: v.numpy() for k, v in params.items()},
            {k: v.numpy() for k, v in center.items()})


@pytest.mark.parametrize("rule", ["downpour", "easgd"])
def test_update_drivers_bit_equal_to_jax(clean, rule):
    from torchmpi_tpu.parameterserver import native as jnative
    from torchmpi_tpu.parameterserver import update as jupdate

    if rule == "downpour":
        kw = dict(lr=0.1, init_delay=1, update_frequency=2)
        pair = (jupdate.DownpourUpdate, DownpourUpdate)
    else:
        kw = dict(beta=0.9, size=1, init_delay=1, update_frequency=2)
        pair = (jupdate.EASGDUpdate, EASGDUpdate)
    _, eps = _servers(jnative, 4)
    _jps().init_cluster(endpoints=eps, start_server=False)
    want_p, want_c = _drive(pair[0], kw, "jax")
    _, eps = _servers(tnative, 4)
    tps.init_cluster(endpoints=eps, start_server=False)
    got_p, got_c = _drive(pair[1], kw, "port")
    for k in want_p:
        assert got_p[k].tobytes() == want_p[k].tobytes(), k
        assert got_c[k].tobytes() == want_c[k].tobytes(), k
    assert any(np.any(v != 0) for v in got_c.values())


# ----------------------------------------------- durability and failover

def _pull_direct(port, instance, n):
    L = tnative.lib()
    peer = L.tmpi_ps_connect(b"127.0.0.1", port)
    out = np.full((n,), np.nan, np.float32)
    ok = L.tmpi_ps_pull(peer, instance, F32, 0, n, out.ctypes.data)
    L.tmpi_ps_disconnect(peer)
    return out if ok == 1 else None


def _restart_server_from(port, snapdir):
    L = tnative.lib()
    c = tps._cluster
    L.tmpi_ps_server_stop(c.server_id)
    sid = L.tmpi_ps_server_start(port)
    assert sid > 0
    assert L.tmpi_ps_restore_dir(sid, snapdir.encode()) >= 0
    c.server_id = sid
    return sid


def _durable_cluster(tmp_path, **kw):
    from torchmpi_tpu_torch.collectives.hostcomm import free_ports

    port = free_ports(1)[0]
    d = str(tmp_path / "snaps")
    tconfig.reset(**{"ps_snapshot_dir": d, "ps_epoch_fence": True, **FAST,
                     **kw})
    tps.init_cluster(listen_port=port)
    return port, d


def case_snapshot_roundtrip_and_torn_fallback(tmp_path):
    L = tnative.lib()
    d = tmp_path / "snaps"
    sid = L.tmpi_ps_server_start(0)
    assert L.tmpi_ps_restore_dir(sid, str(d).encode()) == 0
    assert L.tmpi_ps_server_epoch(sid) == 1
    peer = L.tmpi_ps_connect(b"127.0.0.1", L.tmpi_ps_server_port(sid))
    old, new = np.full(8, 1.0, np.float32), np.full(8, 9.0, np.float32)
    assert L.tmpi_ps_create(peer, 1, 8, F32, 1) == 1
    assert L.tmpi_ps_push(peer, 1, tnative.RULE_COPY, F32, 0, 8,
                          old.ctypes.data) == 1
    assert L.tmpi_ps_snapshot(sid) == 1
    assert L.tmpi_ps_push(peer, 1, tnative.RULE_COPY, F32, 0, 8,
                          new.ctypes.data) == 1
    assert L.tmpi_ps_snapshot(sid) == 1
    L.tmpi_ps_disconnect(peer)
    L.tmpi_ps_server_stop(sid)
    snaps = sorted(f for f in os.listdir(d) if f.endswith(".tmpips"))
    assert len(snaps) >= 2
    torn = tnative.snapshot_torn_count()
    for name in snaps[1:]:
        blob = (d / name).read_bytes()
        (d / name).write_bytes(blob[:len(blob) // 2])
    sid2 = L.tmpi_ps_server_start(0)
    assert L.tmpi_ps_restore_dir(sid2, str(d).encode()) == 1
    assert L.tmpi_ps_server_epoch(sid2) == 2
    assert tnative.snapshot_torn_count() - torn == len(snaps) - 1
    np.testing.assert_array_equal(
        _pull_direct(L.tmpi_ps_server_port(sid2), 1, 8), old)
    L.tmpi_ps_server_stop(sid2)


def case_stale_epoch_push_nacked(tmp_path):
    L = tnative.lib()
    sid = L.tmpi_ps_server_start(0)
    L.tmpi_ps_restore_dir(sid, str(tmp_path / "s").encode())
    port = L.tmpi_ps_server_port(sid)
    peer = L.tmpi_ps_connect(b"127.0.0.1", port)
    base, delta = np.full(8, 1.0, np.float32), np.full(8, 5.0, np.float32)
    assert L.tmpi_ps_create(peer, 3, 8, F32, 1) == 1
    epoch = int(L.tmpi_ps_fetch_epoch(peer))
    assert epoch == 1
    assert L.tmpi_ps_push_fenced(peer, 3, tnative.RULE_COPY, F32, 0, 8,
                                 base.ctypes.data, epoch) == 1
    fences = tnative.epoch_fence_count()
    assert L.tmpi_ps_push_fenced(peer, 3, tnative.RULE_ADD, F32, 0, 8,
                                 delta.ctypes.data, epoch + 7) == -2
    assert tnative.epoch_fence_count() == fences + 1
    # Epoch 0 is unfenced: it applies.
    assert L.tmpi_ps_push_fenced(peer, 3, tnative.RULE_ADD, F32, 0, 8,
                                 delta.ctypes.data, 0) == 1
    np.testing.assert_array_equal(_pull_direct(port, 3, 8), base + delta)
    L.tmpi_ps_disconnect(peer)
    L.tmpi_ps_server_stop(sid)


def _add_replay(tmp_path, fence):
    port, d = _durable_cluster(tmp_path, ps_epoch_fence=fence)
    t = tps.init(np.ones(32, np.float32))
    tnative.lib().tmpi_ps_server_drop_push_acks(tps._cluster.server_id, 1)
    h = tps.send(t, np.full(32, 4.0, np.float32), rule="add")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        out = _pull_direct(port, t.instance, 32)
        if out is not None and np.allclose(out, 5.0):
            break
        time.sleep(0.02)
    _restart_server_from(port, d)
    reseeds = tps.client_counters().get("tmpi_ps_reseed_total", 0)
    h.wait()
    hh, out = tps.receive(t)
    hh.wait()
    return out.numpy(), tps.client_counters().get(
        "tmpi_ps_reseed_total", 0) - reseeds


def case_add_replay_exactly_once(tmp_path):
    out, reseeded = _add_replay(tmp_path, fence=True)
    np.testing.assert_allclose(out, np.full(32, 5.0))     # 1 + 4, once
    assert reseeded > 0


def case_add_replay_fence_off_double_applies(tmp_path):
    out, _ = _add_replay(tmp_path, fence=False)
    np.testing.assert_allclose(out, np.full(32, 9.0))     # 1 + 4 + 4


def case_send_and_receive_ride_server_restart(tmp_path):
    port, d = _durable_cluster(tmp_path)
    t = tps.init(np.full(8, 2.0, np.float32))
    _restart_server_from(port, d)
    failovers = tps.client_counters().get("tmpi_ps_failover_total", 0)
    tps.send(t, np.full(8, 3.0, np.float32), rule="add").wait()
    hh, out = tps.receive(t)
    hh.wait()
    np.testing.assert_allclose(out.numpy(), np.full(8, 5.0))
    assert tps._cluster.epochs[0] >= 2
    assert tps.client_counters()["tmpi_ps_failover_total"] > failovers
    _restart_server_from(port, d)
    hh, out = tps.receive(t)
    hh.wait()
    np.testing.assert_allclose(out.numpy(), np.full(8, 5.0))


def case_failover_off_raises(tmp_path):
    port, d = _durable_cluster(tmp_path, ps_failover_max=0,
                               ps_request_deadline_ms=2000)
    t = tps.init(np.ones(8, np.float32))
    _restart_server_from(port, d)
    with pytest.raises(PSTransportError):
        tps.send(t, np.ones(8, np.float32), rule="add").wait()


def case_fenced_push_without_failover_is_fence_error(tmp_path):
    port, d = _durable_cluster(tmp_path, ps_request_deadline_ms=2000)
    t = tps.init(np.ones(8, np.float32))
    _restart_server_from(port, d)
    assert tnative.lib().tmpi_ps_ping(tps._cluster.peers[0]) == 1
    tconfig.set("ps_failover_max", 0)
    with pytest.raises(PSFenceError):
        tps.send(t, np.ones(8, np.float32), rule="add").wait()


def _repl_cluster():
    tconfig.reset(ps_replication=True, ps_epoch_fence=True,
                  ps_promote_reconnect_max=1,
                  **{**FAST, "ps_failover_max": 4})
    tnative.apply_config()
    sids, eps = _servers(tnative, 3)
    tps.init_cluster(endpoints=eps, start_server=False)
    return eps, sids


def case_promotion_exact_with_flight_dump(tmp_path):
    eps, sids = _repl_cluster()
    tconfig.set("obs_flight", True)
    tconfig.set("obs_flight_dir", str(tmp_path / "flight"))
    t = tps.init(np.arange(48, dtype=np.float32))
    tps.send(t, np.ones(48, np.float32), rule="add").wait()
    c = tps._cluster
    victim = tps._owner_slot(c, t.instance, 0)
    tnative.lib().tmpi_ps_server_stop(sids[victim])
    tps.send(t, np.ones(48, np.float32), rule="add").wait()
    h, buf = tps.receive(t)
    h.wait()
    np.testing.assert_allclose(buf.numpy(), np.arange(48) + 2)
    assert c.alive[victim] is False and victim not in c.ring.slots
    assert tps.client_counters()["tmpi_ps_promote_total"] >= 1
    tps.barrier()
    dumps = os.listdir(tmp_path / "flight")
    assert any(n.endswith("ps_promote.json") for n in dumps), dumps
    import json

    bundle = json.loads((tmp_path / "flight" / sorted(dumps)[-1]).read_text())
    assert bundle["schema"] == "tmpi-flight-v1" and "retry" in \
        bundle["counters"]


def case_handoff_cuts_over_and_torn_handoff_keeps_owner(tmp_path):
    eps, sids = _repl_cluster()
    L = tnative.lib()
    t = tps.init(np.full(48, 2.0, np.float32))
    tps.send(t, np.ones(48, np.float32), rule="add").wait()
    c = tps._cluster
    victim = tps._owner_slot(c, t.instance, 0)
    handoffs = tnative.handoff_count()
    fresh = L.tmpi_ps_server_start(0)
    tps.handoff(victim, ("127.0.0.1", L.tmpi_ps_server_port(fresh)))
    assert tnative.handoff_count() == handoffs + 1
    tps.send(t, np.ones(48, np.float32), rule="add").wait()
    h, buf = tps.receive(t)
    h.wait()
    np.testing.assert_allclose(buf.numpy(), np.full(48, 4.0))
    other = next(s for s in c.ring.slots if s != victim)
    torn = tnative.handoff_torn_count()
    with pytest.raises(PSTransportError):
        tps.handoff(other, ("127.0.0.1", 1))
    assert tnative.handoff_torn_count() == torn + 1
    tps.send(t, np.ones(48, np.float32), rule="add").wait()
    h, buf = tps.receive(t)
    h.wait()
    np.testing.assert_allclose(buf.numpy(), np.full(48, 5.0))


def case_colocated_partial_ack_exactly_once(tmp_path):
    eps, sids = _repl_cluster()
    c = tps._cluster
    t = tps.init(np.ones(48, np.float32))        # instance 1: co-located
    owners = [tps._owner_slot(c, t.instance, k) for k in range(3)]
    dup = [s for s in set(owners) if owners.count(s) > 1]
    assert dup, owners
    tnative.lib().tmpi_ps_server_drop_push_acks(sids[dup[0]], 1)
    tps.send(t, np.full(48, 2.0, np.float32), rule="add").wait()
    h, buf = tps.receive(t)
    h.wait()
    np.testing.assert_allclose(buf.numpy(), np.full(48, 3.0))


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_durability_and_failover(clean, tmp_path, name):
    CASES[name](tmp_path)
