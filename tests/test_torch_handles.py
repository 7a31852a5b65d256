"""The port's synchronization handles (``runtime/handles.py``) against the
JAX package's ``torchmpi_tpu/runtime/handles.py``.

The same scenario runs on both modules' handles and registries, with a
``concurrent.futures.Future``, a native wait function and ready payloads,
and the observable traces (payloads, ``done`` before and after a wait,
callback order, how often a native wait runs, when the in-flight registry
flushes) must be equal.  The torch-only arm, a ``torch.distributed``
``Work``, is held to the same contract with a stand-in work object.
"""

from __future__ import annotations

from concurrent.futures import Future

import pytest

from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime import handles as thandles


def _modules():
    from torchmpi_tpu.runtime import handles as jhandles

    return {"jax": jhandles, "torch": thandles}


def _lifecycle_trace(mod):
    trace = []
    fut = Future()
    h = mod.SynchronizationHandle.from_future(fut)
    h.add_done_callback(lambda: trace.append("cb1"))
    h.add_done_callback(lambda: trace.append("cb2"))
    trace.append(("done before result", h.done))
    fut.set_result(7)
    trace.append(("done after result", h.done))
    trace.append(("wait", h.wait()))
    trace.append(("done after wait", h.done))
    h.add_done_callback(lambda: trace.append("cb3 at once"))
    trace.append(("wait again", h.wait()))

    runs = []
    n = mod.SynchronizationHandle.from_native(lambda: runs.append(1) or 5)
    trace.append(("native", n.wait(), n.wait(), len(runs)))
    np_ = mod.SynchronizationHandle.from_native(lambda: 9, payload="mine")
    trace.append(("native with payload", np_.wait()))
    r = mod.SynchronizationHandle.ready(3)
    trace.append(("ready", r.done, r.wait()))
    a = mod.SynchronizationHandle.from_arrays([1, 2])
    trace.append(("arrays", a.done, a.wait(), a.done))
    trace.append(("module wait", mod.wait(None), mod.wait(r)))
    trace.append(("wait_all", mod.wait_all([r, None, n, np_])))
    trace.append(repr(r).split("<")[0])
    return trace


def test_handle_lifecycle_matches_jax():
    m = _modules()
    assert _lifecycle_trace(m["torch"]) == _lifecycle_trace(m["jax"])


def _registry_trace(mod, limit):
    reg = mod._InFlightRegistry()
    waited = []
    trace = []
    for i in range(5):
        reg.register(mod.SynchronizationHandle.from_native(
            lambda i=i: waited.append(i)), limit)
        trace.append((i, len(reg), list(waited)))
    reg.sync_all()
    trace.append(("sync_all", len(reg), list(waited)))
    return trace


@pytest.mark.parametrize("limit", [1, 2, 3, 1 << 20])
def test_in_flight_limit_matches_jax(limit):
    m = _modules()
    assert _registry_trace(m["torch"], limit) == _registry_trace(m["jax"],
                                                                 limit)


def test_register_reads_the_in_flight_knob():
    from torchmpi_tpu.runtime import config as jconfig

    assert tconfig.get("num_async_collectives_in_flight") == jconfig.get(
        "num_async_collectives_in_flight")
    thandles.sync_all()
    tconfig.reset(num_async_collectives_in_flight=2)
    try:
        waited = []
        hs = [thandles.register(thandles.SynchronizationHandle.from_native(
            lambda i=i: waited.append(i))) for i in range(3)]
        assert waited == [0, 1] and [h.done for h in hs] == [True, True,
                                                              False]
        assert len(thandles.in_flight) == 1
        thandles.sync_all()
        assert waited == [0, 1, 2] and len(thandles.in_flight) == 0
    finally:
        tconfig.reset()


def test_waited_handles_leave_the_registry_at_the_next_registration():
    # The port's one departure from JAX: a handle its owner waited no
    # longer holds its payload in the registry.
    reg = thandles._InFlightRegistry()
    hs = [thandles.SynchronizationHandle.from_native(lambda: None)
          for _ in range(3)]
    for h in hs:
        reg.register(h, 1 << 20)
    hs[0].wait()
    hs[2].wait()
    new = thandles.SynchronizationHandle.from_native(lambda: None)
    reg.register(new, 1 << 20)
    assert reg._handles == [hs[1], new]


def test_work_handle_waits_once_then_finishes_the_payload():
    class Work:
        waits = 0

        def wait(self):
            Work.waits += 1
            return True

    h = thandles.SynchronizationHandle.from_work(Work(), [1, 2],
                                                 finish=lambda p: sum(p))
    assert not h.done and "work" in repr(h)
    assert h.wait() == 3 and h.wait() == 3 and Work.waits == 1 and h.done


def test_fence_is_none_off_the_card():
    import torch

    assert thandles.fence(torch.zeros(2)) is None
    assert thandles.fence([1]) is None
