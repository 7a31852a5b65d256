"""Parameter trees in the JAX package's leaf order.

The port keeps parameters as nested dicts and lists, as the JAX package
does, and flattens them the way ``jax.tree.flatten`` does: dict keys
**sorted**, lists and tuples in order, ``None`` an empty subtree.
``torch.utils._pytree`` keeps dict insertion order instead, which would
change which leaf gets which ring collective id, how small leaves pack into
the tail bucket, and so the order of every sum.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = "*"


def flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: leaves in JAX order; ``treedef`` rebuilds the
    structure in :func:`unflatten`."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, len(t), tuple(walk(x) for x in t))
        if t is None:
            return ("none",)
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(d):
        if d == _LEAF:
            return next(it)
        kind = d[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "none":
            return None
        children = [build(c) for c in d[2]]
        return children if kind == "list" else tuple(children)

    out = build(treedef)
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


def flatten_with_paths(tree: Any) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``(path, leaf)`` pairs in JAX order, as
    ``jax.tree_util.tree_flatten_with_path`` gives them: a path is the dict
    keys and sequence indices from the root to the leaf."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, path + (i,))
        elif t is not None:
            out.append((path, t))

    walk(tree, ())
    return out
