"""Optimizers shaped like optax's: ``adam`` and ``sgd``.

The JAX package hands its engine and its Llama step an optax
``GradientTransformation``; the port's counterpart is an object with the
same two functions:

* ``init(params) -> state``;
* ``update(grads, state, params=None) -> (updates, state)``, the updates
  added to the parameters as ``p + u``.

The states mirror optax's structure, so a checkpoint of either package
holds the same leaves under the same paths: ``adam`` is ``(ScaleByAdamState
(count, mu, nu), EmptyState())``, ``sgd`` is ``(TraceState(trace),
EmptyState())`` with momentum and ``(EmptyState(), EmptyState())`` without.
The count is an int32 scalar, incremented before the bias correction; the
moments are held in the parameter's dtype.

The algebra is optax's step for step (``scale_by_adam``,
``tree_update_moment``, ``tree_bias_correction``, ``trace``,
``scale_by_learning_rate``), in its dtypes: a Python constant meets a
tensor rounded to that tensor's dtype first, as JAX's weakly typed scalars
do, and every operation rounds once.  The bias correction ``1 - b**count``
is computed once an update, on the device in f32, and cast to the moment's
dtype before the division.

An update over a tree runs as a few ``torch._foreach_*`` launches over all
its leaves.  ``apply_`` does the same update in place, leaf by leaf in
slices of at most ``chunk_bytes``, and frees each gradient once its leaf is
updated: the Llama step's form, whose moments beside the parameters leave
no room for a second copy of the tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils import tree as _tree

_INT32_MAX = 2 ** 31 - 1


class EmptyState(NamedTuple):
    """optax's ``EmptyState``."""


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState``."""
    count: Any
    mu: Any
    nu: Any


class TraceState(NamedTuple):
    """optax's ``TraceState``."""
    trace: Any


def _const(x: float, dtype: torch.dtype) -> float:
    """``x`` as a tensor of ``dtype`` holds it (JAX's weak-type rule)."""
    return float(torch.tensor(x, dtype=dtype))


def _consts(x: float, leaves: Sequence[torch.Tensor]) -> List[float]:
    return [_const(x, t.dtype) for t in leaves]


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: +1, staying at the int32 maximum."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay**count`` in f32 on the count's device (a Python
    base: no host-to-device copy, so no wait for the stream)."""
    return 1 - torch.pow(decay, count.to(torch.float32))


def _div_bias(moments: List[torch.Tensor],
              bc: torch.Tensor) -> List[torch.Tensor]:
    """optax's ``tree_bias_correction``: each moment divided by the f32
    correction cast to its dtype."""
    out: List[Optional[torch.Tensor]] = [None] * len(moments)
    for idx in _tree.by_dtype(moments):
        res = torch._foreach_div([moments[i] for i in idx],
                                 bc.to(moments[idx[0]].dtype))
        for i, r in zip(idx, res):
            out[i] = r
    return out


def _moment(g: List[torch.Tensor], t: List[torch.Tensor],
            decay: float) -> List[torch.Tensor]:
    """``(1 - decay) * g + decay * t``, each product and the sum rounded
    once."""
    a = torch._foreach_mul(g, _consts(1 - decay, g))
    b = torch._foreach_mul(t, _consts(decay, t))
    return torch._foreach_add(a, b)


@dataclasses.dataclass(frozen=True, eq=False)
class _Transform:
    """What both optimizers share: ``_core`` maps lists of leaves;
    ``update`` and ``apply_`` map whole trees through it."""

    def init(self, params: Any):
        raise NotImplementedError

    def _core(self, g, state_lists, aux):
        """``(updates, new state lists)`` for lists of gradient leaves and
        the matching state leaves; ``aux`` is :meth:`_prepare`'s."""
        raise NotImplementedError

    def _prepare(self, count):
        """What every slice of one update shares, from the incremented
        count (Adam: its two bias corrections)."""
        return None

    def _split(self, state) -> Tuple[Optional[torch.Tensor], List[list],
                                     Any]:
        """(count or None, the param-shaped state trees' leaf lists, a
        function rebuilding the state from count and lists)."""
        raise NotImplementedError

    def update(self, grads: Any, state: Any, params: Any = None):
        """optax's ``update``: ``(updates, new_state)``, new tensors."""
        del params
        g, treedef = _tree.flatten(grads)
        count, lists, rebuild = self._split(state)
        count = _increment(count) if count is not None else None
        u, new_lists = self._core(g, [_tree.leaves(s) for s in lists],
                                  self._prepare(count))
        return (_tree.unflatten(treedef, u),
                rebuild(count, [_tree.unflatten(treedef, lst)
                                for lst in new_lists]))

    def apply_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Any, chunk_bytes: int = 1 << 28):
        """The same update applied in place: ``params`` and the state's
        tensors (lists in tree order) are overwritten with ``p + u`` and
        the new moments, slice by slice along the leading dimension, and
        ``grads[i]`` is set to None once leaf i is done.  Returns the new
        state (its count a new tensor, its moments the same tensors)."""
        count, lists, rebuild = self._split(state)
        count = _increment(count) if count is not None else None
        aux = self._prepare(count)
        leaf_lists = [_tree.leaves(s) for s in lists]
        with torch.no_grad():
            for i, p in enumerate(params):
                rows = p.shape[0] if p.ndim else 1
                row_bytes = max(1, p.numel() * p.element_size() // max(rows, 1))
                step = max(1, chunk_bytes // row_bytes)
                for lo in range(0, rows, step):
                    sl = (slice(lo, lo + step),) if p.ndim else ()
                    g = [grads[i][sl]]
                    st = [[lst[i][sl]] for lst in leaf_lists]
                    (u,), new = self._core(g, st, aux)
                    p[sl].add_(u)
                    for dst, (src,) in zip(st, new):
                        dst[0].copy_(src)
                grads[i] = None
        return rebuild(count, lists)


@dataclasses.dataclass(frozen=True, eq=False)
class Adam(_Transform):
    """optax's ``adam``: ``scale_by_adam`` then ``scale_by_learning_rate``."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params: Any):
        leaves = _tree.leaves(params)
        dev = leaves[0].device if leaves else "cpu"
        zeros = lambda: _tree.tree_map(torch.zeros_like, params)  # noqa: E731
        return (ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=zeros(), nu=zeros()), EmptyState())

    def _split(self, state):
        adam, _ = state
        return (adam.count, [adam.mu, adam.nu],
                lambda c, trees: (ScaleByAdamState(c, *trees), EmptyState()))

    def _prepare(self, count):
        return (_bias_correction(self.b1, count),
                _bias_correction(self.b2, count))

    def _core(self, g, state_lists, aux):
        mu, nu = state_lists
        mu = _moment(g, mu, self.b1)
        nu = _moment(torch._foreach_mul(g, g), nu, self.b2)
        mu_hat = _div_bias(mu, aux[0])
        nu_hat = _div_bias(nu, aux[1])
        den = torch._foreach_sqrt(
            torch._foreach_add(nu_hat, _consts(self.eps_root, nu_hat)))
        den = torch._foreach_add(den, _consts(self.eps, den))
        u = torch._foreach_div(mu_hat, den)
        u = torch._foreach_mul(u, _consts(-self.learning_rate, u))
        return u, [mu, nu]


@dataclasses.dataclass(frozen=True, eq=False)
class Sgd(_Transform):
    """optax's ``sgd``: ``trace`` (with momentum) then
    ``scale_by_learning_rate``."""

    learning_rate: float
    momentum: Optional[float] = None

    def init(self, params: Any):
        if self.momentum is None:
            return (EmptyState(), EmptyState())
        return (TraceState(_tree.tree_map(torch.zeros_like, params)),
                EmptyState())

    def _split(self, state):
        if self.momentum is None:
            return None, [], lambda c, trees: (EmptyState(), EmptyState())
        return (None, [state[0].trace],
                lambda c, trees: (TraceState(trees[0]), EmptyState()))

    def _core(self, g, state_lists, aux):
        if self.momentum is None:
            return torch._foreach_mul(g, _consts(-self.learning_rate, g)), []
        (t,) = state_lists
        t = torch._foreach_add(g, torch._foreach_mul(
            t, _consts(self.momentum, t)))
        return torch._foreach_mul(t, _consts(-self.learning_rate, t)), [t]


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Adam:
    """optax's ``adam`` (no schedule, no Nesterov, moments in the
    parameters' dtype)."""
    return Adam(learning_rate, b1, b2, eps, eps_root)


def sgd(learning_rate: float, momentum: Optional[float] = None) -> Sgd:
    """optax's ``sgd`` (no schedule, no Nesterov)."""
    return Sgd(learning_rate, momentum)


def apply_updates(params: Any, updates: Any) -> Any:
    """``p + u`` leaf by leaf (optax's ``apply_updates``, as the JAX engine
    writes it); new tensors."""
    with torch.no_grad():
        p, treedef = _tree.flatten(params)
        return _tree.unflatten(treedef, torch._foreach_add(
            p, _tree.leaves(updates)))


# ------------------------------------------------------------ from optax

def _tensor(a: Any, like: torch.Tensor, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: carry the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device if device is not None else like.device, like.dtype)


def from_jax_opt_state(optax_state: Any, like_params: Any, device=None,
                       from_params=None) -> Any:
    """An optax ``adam`` or ``sgd`` state (numpy or JAX arrays) as the
    port's, so that both packages can start from one state.  The
    parameter-shaped trees (``mu``, ``nu``, ``trace``) are converted by
    ``from_params`` (a model's ``from_jax_params``, which also lays out
    convolution weights) when given, else leaf by leaf; each leaf then
    takes the dtype of ``like_params``'s leaf and lands on ``device``
    (default: that leaf's device).  The count stays int32."""
    like, _ = _tree.flatten(like_params)
    dev = device if device is not None else (like[0].device if like
                                             else "cpu")

    def params_tree(tree):
        if from_params is not None:
            conv = from_params(tree, device=dev)
            return _tree.unflatten(_tree.flatten(like_params)[1], [
                c.to(dev, lk.dtype) for c, lk in zip(_tree.leaves(conv),
                                                     like)])
        leaves, treedef = _tree.flatten(tree)
        return _tree.unflatten(treedef, [_tensor(a, lk, dev)
                                         for a, lk in zip(leaves, like)])

    def walk(s):
        fields = getattr(type(s), "_fields", None)
        if fields is None:
            if isinstance(s, (list, tuple)):
                return tuple(walk(x) for x in s)
            raise TypeError(f"not an optax adam or sgd state: {s!r}")
        if fields == ():
            return EmptyState()
        if tuple(fields) == ("count", "mu", "nu"):
            count = torch.tensor(int(np.asarray(s.count)), dtype=torch.int32,
                                 device=dev)
            return ScaleByAdamState(count, params_tree(s.mu),
                                    params_tree(s.nu))
        if tuple(fields) == ("trace",):
            return TraceState(params_tree(s.trace))
        raise TypeError(f"no port of the optax state {type(s).__name__}")

    return walk(optax_state)
