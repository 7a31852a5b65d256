"""The port's collective selector against the JAX package's static table.

* For every setting of ``use_pallas_collectives`` and
  ``use_hierarchical_collectives`` the port's table equals JAX's
  ``selector._table`` cell for cell, ``availability()`` prints the same
  lines, and every collective resolves, in every cell, to the executable
  of the same name.  The port's table follows a knob changed after it was
  built.
* Placement: a CPU tensor goes to the host column only in a world started
  on the card; in a world started on the CPU (the card's stand-in), and
  for any tensor not on the CPU, it stays on the device column.  Scope
  follows ``need_inter_node_collectives``.
"""

from __future__ import annotations

import itertools

import pytest
import torch

from torchmpi_tpu_torch.collectives import selector as tsel
from torchmpi_tpu_torch.runtime import config as tconfig

KNOBS = list(itertools.product([False, True], [False, True]))
COLLECTIVES = ("allreduce", "broadcast", "reduce", "allgather",
               "reduce_scatter", "sendreceive", "alltoall", "barrier")


@pytest.fixture()
def knobs(request):
    from torchmpi_tpu.collectives import selector as jsel
    from torchmpi_tpu.runtime import config as jconfig

    rings, hier = request.param
    kw = dict(use_pallas_collectives=rings, use_hierarchical_collectives=hier)
    jconfig.reset(**kw)
    tconfig.reset(**kw)
    jsel.configure()
    tsel.configure()
    yield jsel
    jconfig.reset()
    tconfig.reset()
    jsel.configure()
    tsel.configure()


@pytest.mark.parametrize("knobs", KNOBS, indirect=True,
                         ids=[f"rings{int(a)}-hier{int(b)}" for a, b in KNOBS])
def test_table_and_availability_equal_jax(knobs):
    jsel = knobs
    assert tsel._table == jsel._table
    assert tsel.availability() == jsel.availability()
    for cell in tsel._table:
        assert tsel.select(*cell) == jsel.select(*cell)


@pytest.mark.parametrize("collective", COLLECTIVES)
@pytest.mark.parametrize("knobs", KNOBS, indirect=True,
                         ids=[f"rings{int(a)}-hier{int(b)}" for a, b in KNOBS])
def test_every_cell_resolves_as_jax(knobs, collective):
    jsel = knobs
    for placement, scope, mode in tsel._table:
        try:
            want = jsel.resolve(collective, placement, scope, mode).__name__
        except KeyError:
            with pytest.raises(KeyError, match="no implementation"):
                tsel.resolve(collective, placement, scope, mode)
            continue
        got = tsel.resolve(collective, placement, scope, mode)
        assert got.__name__ == want, (placement, scope, mode)


def test_table_follows_its_knobs():
    tconfig.reset()
    tsel.configure()
    try:
        assert tsel.preferences("tpu", "singlenode") == ["xla", "pallas"]
        tconfig.set("use_pallas_collectives", True)
        assert tsel.preferences("tpu", "singlenode") == ["pallas", "xla"]
        tconfig.set("use_hierarchical_collectives", False)
        assert "hierarchical" not in tsel.preferences("tpu", "multinode")
    finally:
        tconfig.reset()
        tsel.configure()
    with pytest.raises(ValueError, match="mode"):
        tsel.resolve("allreduce", mode="eager")
    with pytest.raises(KeyError, match="no selector entry"):
        tsel.preferences("gpu", "singlenode")


@pytest.mark.parametrize("started_on", [None, "cpu", "cuda"])
def test_placement_follows_the_payload_and_the_world(monkeypatch, started_on):
    from torchmpi_tpu_torch.runtime import lifecycle

    monkeypatch.setattr(lifecycle, "started", lambda: started_on is not None)
    monkeypatch.setattr(lifecycle, "device",
                        lambda: torch.device(started_on or "cpu"))
    host = started_on == "cuda"
    assert tsel._auto_placement(torch.zeros(3)) == ("cpu" if host else "tpu")
    assert tsel._auto_placement(torch.zeros(3, device="meta")) == "tpu"
    assert tsel._auto_placement(None) == "tpu"
    assert tsel._auto_placement(3.0) == "tpu"
    assert tsel.select(payload=torch.zeros(3)) == (
        "hostcomm" if host else "xla")
    fn = tsel.resolve("allreduce", payload=torch.zeros(3))
    assert fn.__name__ == ("_hostcomm_allreduce" if host else
                           "_xla_allreduce")


def test_scope_follows_the_inter_node_flag(monkeypatch):
    from torchmpi_tpu_torch.runtime import lifecycle

    tconfig.reset()
    assert tsel._auto_scope() == "singlenode"
    monkeypatch.setattr(lifecycle, "need_inter_node_collectives",
                        lambda: True)
    assert tsel._auto_scope() == "multinode"
    assert tsel.select() == "hierarchical"
