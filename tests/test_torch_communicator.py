"""The port's communicator splits and stack cursor against the JAX package's,
with no world started.

* For the key functions of ``tests/test_runtime.py`` and
  ``tests/test_mesh_sweep.py`` at p in {2, 3, 4, 6, 8}, under each setting
  of the split knobs (cartesian, forced tree, flat), a level pushed on the
  world and a second level pushed on it have JAX's ``group_ranks``,
  ``inter_group_ranks``, ``root_ranks`` and ``cartesian`` exactly, and
  ``intra_rank_of`` agrees for every rank.
* The cursor: ``push`` moves the level and the span, ``set_communicator``
  and ``set_collective_span`` move them as JAX's do and raise the same
  ``IndexError`` s, ``CommunicatorGuard`` restores them, ``names()`` prints
  JAX's lines, and ``groups_for_cursor`` resolves every cursor state of a
  three-level stack to JAX's groups.
"""

from __future__ import annotations

import pytest

from torchmpi_tpu_torch.collectives import hierarchical as thier
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime.communicator import (Communicator,
                                                     CommunicatorGuard,
                                                     CommunicatorStack,
                                                     CommunicatorType)

SIZES = (2, 3, 4, 6, 8)
KEYS = {
    "mod2": lambda r: r % 2,
    "mod3": lambda r: r % 3,
    "mod5": lambda r: r % 5,
    "div2": lambda r: r // 2,
    "div4": lambda r: r // 4,
}
# (use_cartesian_communicators, use_tree_communicators)
MODES = {"cartesian": (True, False), "tree": (False, True),
         "flat": (False, False)}


@pytest.fixture()
def knobs(request):
    from torchmpi_tpu.runtime import config as jconfig

    cart, tree = MODES[request.param]
    jconfig.reset(use_cartesian_communicators=cart,
                  use_tree_communicators=tree)
    tconfig.reset(use_cartesian_communicators=cart,
                  use_tree_communicators=tree)
    yield request.param
    jconfig.reset()
    tconfig.reset()


def _stacks(p):
    import jax

    from torchmpi_tpu.runtime.communicator import (Communicator as JComm,
                                                   CommunicatorStack as JStack)

    js, ts = JStack(), CommunicatorStack()
    js.reset(JComm(jax.devices()[:p]))
    ts.reset(Communicator(range(p), my_rank=0))
    return js, ts


def _tables(c):
    return (c.group_ranks, c.inter_group_ranks, c.root_ranks, c.cartesian,
            c.num_groups, [c.intra_rank_of(r) for r in range(c.size)])


@pytest.mark.parametrize("knobs", list(MODES), indirect=True)
@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("p", SIZES)
def test_split_tables_equal_jax(knobs, key, p):
    js, ts = _stacks(p)
    assert _tables(ts.world()) == _tables(js.world())
    for second in (None, "mod2"):
        for k in (key, second) if second else (key,):
            assert ts.push(KEYS[k]) == js.push(KEYS[k])
        assert _tables(ts.current()) == _tables(js.current())
        assert ts.names() == js.names()
        js, ts = _stacks(p)


def test_key_too_long_and_one_key_per_rank():
    with pytest.raises(ValueError, match="too long"):
        Communicator(range(4), ["x" * 2000] * 4)
    with pytest.raises(ValueError, match="one key"):
        Communicator(range(3), ["a"])


def test_cursor_and_span_follow_jax():
    from torchmpi_tpu.runtime.communicator import \
        CommunicatorType as JType

    js, ts = _stacks(8)
    for s in (js, ts):
        assert (s.level, s.span, s.depth) == (0, (0, 1), 1)
    for keys in (lambda r: r // 4, lambda r: r % 2):
        assert ts.push(keys) == js.push(keys)
        assert (ts.level, ts.span) == (js.level, js.span)
    moves = [("set_communicator", (0,)), ("set_collective_span", (0, 2)),
             ("set_collective_span", (1, 3)), ("set_communicator", (2,)),
             ("set_communicator", (1, "inter"))]
    for name, args in moves:
        targs = tuple(CommunicatorType.INTER if a == "inter" else a
                      for a in args)
        jargs = tuple(JType.INTER if a == "inter" else a for a in args)
        getattr(ts, name)(*targs)
        getattr(js, name)(*jargs)
        assert (ts.level, ts.span, ts.type.value) == (
            js.level, js.span, js.type.value)
        assert ts.names() == js.names()
    for name, args in [("set_collective_span", (0, 5)),
                       ("set_collective_span", (2, 2)),
                       ("set_communicator", (7,)),
                       ("set_communicator", (-1,))]:
        for s in (ts, js):
            with pytest.raises(IndexError):
                getattr(s, name)(*args)


def test_communicator_guard_restores_the_cursor():
    _, ts = _stacks(8)
    level = ts.push(lambda r: r // 4)
    ts.set_collective_span(0, 2)
    with CommunicatorGuard(ts, level, CommunicatorType.INTER):
        assert ts.level == level and ts.type == CommunicatorType.INTER
        assert ts.span == (level, level + 1)
    assert (ts.level, ts.type, ts.span) == (0, CommunicatorType.INTRA, (0, 2))


def test_world_is_one_node_before_a_world_is_started():
    _, ts = _stacks(4)
    assert ts.world().num_nodes() == 1


# The three-level stack of tests/test_span_semantics.py, cut to 4 ranks:
# level 1 {0,1,2} {3}, level 2 {0,1} {2} {3}.
L1_KEY = [0, 0, 0, 1]
L2_KEY = [0, 0, 1, 0]
CURSORS = [("level", (0,)), ("level", (1,)), ("level", (2,)),
           ("inter", (1,)), ("inter", (2,)), ("span", (0, 2)),
           ("span", (1, 3)), ("span", (0, 3)), ("span", (2, 3))]


@pytest.mark.parametrize("cursor,args", CURSORS,
                         ids=[f"{c}{a}" for c, a in CURSORS])
def test_groups_for_cursor_equal_jax(cursor, args):
    from torchmpi_tpu.collectives import hierarchical as jhier
    from torchmpi_tpu.runtime.communicator import \
        CommunicatorType as JType

    js, ts = _stacks(4)
    for keys in (L1_KEY, L2_KEY):
        js.push(lambda r, k=keys: k[r])
        ts.push(lambda r, k=keys: k[r])
    if cursor == "span":
        js.set_collective_span(*args)
        ts.set_collective_span(*args)
    else:
        inter = cursor == "inter"
        js.set_communicator(*args, JType.INTER if inter else JType.INTRA)
        ts.set_communicator(*args, CommunicatorType.INTER if inter
                            else CommunicatorType.INTRA)
    jcomm, jgroups = jhier.groups_for_cursor(js)
    tcomm, tgroups = thier.groups_for_cursor(ts)
    assert tgroups == jgroups
    assert tcomm is ts.world() and jcomm is js.world()
