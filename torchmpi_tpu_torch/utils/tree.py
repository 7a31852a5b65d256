"""Parameter trees in the JAX package's leaf order.

The port keeps parameters as nested dicts and lists, as the JAX package
does, and flattens them the way ``jax.tree.flatten`` does: dict keys
**sorted**, lists and tuples in order, a ``NamedTuple`` (an optimizer
state) by its fields and rebuilt as its own type, ``None`` an empty
subtree.
``torch.utils._pytree`` keeps dict insertion order instead, which would
change which leaf gets which ring collective id, how small leaves pack into
the tail bucket, and so the order of every sum.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = "*"


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(type(t), "_fields")


# The walks are module-level functions that take their accumulator: a
# nested function that calls itself is a reference cycle (the function and
# the cell it reads itself from), and one holding the leaves would keep
# every tensor it saw alive until the garbage collector next runs.

def _flatten_into(t: Any, leaves: List[Any]) -> Any:
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", tuple(keys),
                tuple(_flatten_into(t[k], leaves) for k in keys))
    if _is_namedtuple(t):
        return ("namedtuple", type(t),
                tuple(_flatten_into(x, leaves) for x in t))
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, len(t),
                tuple(_flatten_into(x, leaves) for x in t))
    if t is None:
        return ("none",)
    leaves.append(t)
    return _LEAF


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: leaves in JAX order; ``treedef`` rebuilds the
    structure in :func:`unflatten`."""
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


def _build(d: Any, it) -> Any:
    if d == _LEAF:
        return next(it)
    kind = d[0]
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    if kind == "none":
        return None
    if kind == "namedtuple":
        return d[1](*(_build(c, it) for c in d[2]))
    children = [_build(c, it) for c in d[2]]
    return children if kind == "list" else tuple(children)


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree holds")
    return out


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    lv, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(x, *(o[i] for o in others))
                          for i, x in enumerate(lv)])


def _paths_into(t: Any, path: Tuple[Any, ...],
                out: List[Tuple[Tuple[Any, ...], Any]]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _paths_into(t[k], path + (k,), out)
    elif _is_namedtuple(t):
        for name, x in zip(type(t)._fields, t):
            _paths_into(x, path + (AttrKey("." + name),), out)
    elif isinstance(t, (list, tuple)):
        for i, x in enumerate(t):
            _paths_into(x, path + (i,), out)
    elif t is not None:
        out.append((path, t))


class AttrKey(str):
    """A ``NamedTuple`` field in a path: the string ``".name"`` (equal to
    it), marked so that :func:`keystr` does not take it for a dict key."""


def flatten_with_paths(tree: Any) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``(path, leaf)`` pairs in JAX order, as
    ``jax.tree_util.tree_flatten_with_path`` gives them: a path is the dict
    keys, sequence indices and ``NamedTuple`` fields (as ``".name"``, the
    string of JAX's ``GetAttrKey``, an :class:`AttrKey`) from the root to
    the leaf."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []
    _paths_into(tree, (), out)
    return out


def keystr(path: Tuple[Any, ...]) -> str:
    """``jax.tree_util.keystr`` of a :func:`flatten_with_paths` path: a
    dict key or a sequence index as ``[repr(key)]``, a field as
    ``.name``."""
    return "".join(k if isinstance(k, AttrKey) else f"[{k!r}]"
                   for k in path)


def by_dtype(leaves: List[Any], idxs=None) -> List[List[int]]:
    """The indices of ``leaves`` (or those in ``idxs``), grouped by dtype
    in order of first appearance, each group in order."""
    groups: dict = {}
    for i in (range(len(leaves)) if idxs is None else idxs):
        groups.setdefault(leaves[i].dtype, []).append(i)
    return list(groups.values())
