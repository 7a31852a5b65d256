"""Tensor (model) parallelism: sharded linear layers with explicit
collectives.

Counterpart of ``torchmpi_tpu/parallel/tp.py``.  The reference ships TP as
an example: ``MPLinear`` shards a Linear's *input* dimension across ranks,
each rank computes a partial product, and the activations are allreduced
forward (and gradInput backward) (reference:
examples/mnist/mnist_modelparallel.lua:28-55).  The two Megatron forms:

* :func:`column_linear` — weight sharded on the **output** dim; no forward
  collective (activations come out feature-sharded).
* :func:`row_linear` — weight sharded on the **input** dim; partial
  products summed over the tp axis — exactly MPLinear's forward.

A column->row pair makes an MLP block with ONE forward collective.  Every
function takes this rank's shards (as a JAX ``shard_map`` body does) and
names the tp axis of a mesh (``mesh=``, or the one entered with ``with
mesh:``).  Each rank differentiates its own program, with no partitioner
to transpose the sums, so the Megatron f/g pair (:func:`block_input`,
:func:`block_output`, autograd Functions standing in for JAX's
``custom_vjp`` s) carries every gradient wire: :func:`row_linear` is
``g``, and :func:`mlp_block` wraps its replicated input in ``f`` so that
the input's gradient arrives whole on every rank.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..collectives import innerjit
from ..models._common import P, generator as _generator, resolve_device
from ..runtime import config
from .mesh import AXIS_TP, Mesh

Params = dict

_WIRE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_wire_dtype(override=None) -> torch.dtype:
    """The wire dtype of the tensor-parallel sums, from the
    ``manual_wire_dtype`` knob (runtime/config.py).

    ``"auto"`` gives f32: the JAX package's rule for every backend that is
    not a TPU (bf16 there), which keeps full partial-sum accuracy.  The
    JAX package first consults its compiled-mode autotune verdict under
    ``autotune_mode=cache|online``; the port has no autotuner yet
    (ROADMAP item 18), so ``"auto"`` is always f32 here.  An explicit
    ``override`` dtype wins over the knob."""
    if override is not None:
        return override
    knob = str(config.get("manual_wire_dtype"))
    if knob == "auto":
        return torch.float32
    if knob not in _WIRE:
        raise ValueError(
            f"manual_wire_dtype must be 'auto', 'bfloat16' or 'float32', "
            f"got {knob!r}")
    return _WIRE[knob]


def _tp_sum(x: torch.Tensor, axis, wire: torch.dtype,
            mesh: Optional[Mesh]) -> torch.Tensor:
    comm = innerjit.axis_comm(axis, mesh)
    if comm.size == 1:
        return x
    return innerjit.allreduce(x.to(wire), axis, mesh=mesh).to(x.dtype)


class _BlockInput(torch.autograd.Function):
    """Megatron ``f``: identity forward, sum over tp backward."""

    @staticmethod
    def forward(ctx, x, axis, wire, mesh):
        ctx.axis, ctx.wire, ctx.mesh = axis, wire, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_sum(g.contiguous(), ctx.axis, ctx.wire, ctx.mesh), None, \
            None, None


class _BlockOutput(torch.autograd.Function):
    """Megatron ``g``: sum over tp forward, identity backward."""

    @staticmethod
    def forward(ctx, part, axis, wire, mesh):
        return _tp_sum(part.contiguous(), axis, wire, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def block_input(x: torch.Tensor, axis: str = AXIS_TP, wire_dtype=None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Megatron ``f``: identity forward, sum over ``axis`` backward.  Wrap
    the (tp-replicated) input of each hand-sharded parallel block.  The
    backward sum is a GRADIENT wire: it rides ``wire_dtype`` (default:
    :func:`resolve_wire_dtype`)."""
    return _BlockInput.apply(x, axis, resolve_wire_dtype(wire_dtype), mesh)


def block_output(part: torch.Tensor, axis: str = AXIS_TP, wire_dtype=None,
                 mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Megatron ``g``: sum over ``axis`` forward, identity backward.
    Reduce the per-shard partials of each hand-sharded parallel block on
    the ``wire_dtype`` wire."""
    return _BlockOutput.apply(part, axis, resolve_wire_dtype(wire_dtype),
                              mesh)


def column_linear(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y_local = x @ w_local (+ b_local); w sharded (d_in, d_out/p).

    Output is feature-sharded; no collective.  ``x`` must be replicated
    across the tp axis."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def row_linear(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, axis: str = AXIS_TP,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """y = sum_tp(x_local @ w_local) (+ b); w sharded (d_in/p, d_out).

    ``x`` is feature-sharded (e.g. a column_linear output).  The sum is the
    activation allreduce of MPLinear's forward, in :func:`block_output`
    (in the partials' dtype, as JAX's ``psum``), whose backward passes the
    whole gradient on.  ``b`` must be replicated — added once, after the
    reduction."""
    part = x @ w
    y = block_output(part, axis, wire_dtype=part.dtype, mesh=mesh)
    if b is not None:
        y = y + b
    return y


def mlp_block(x: torch.Tensor, w_up: torch.Tensor,
              b_up: Optional[torch.Tensor], w_down: torch.Tensor,
              b_down: Optional[torch.Tensor],
              activation: Callable = F.relu, axis: str = AXIS_TP,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Megatron MLP: column(up) -> activation -> row(down); one forward
    sum, and (through :func:`block_input`) one backward sum for ``x``."""
    x = block_input(x, axis, wire_dtype=x.dtype, mesh=mesh)
    h = activation(column_linear(x, w_up, b_up))
    return row_linear(h, w_down, b_down, axis=axis, mesh=mesh)


# ------------------------------------------------------------------ MPLinear
# The reference example as a standalone layer: input-dim sharding only.

def mp_linear_init(rng: Union[int, torch.Generator], d_in: int, d_out: int,
                   dtype=torch.float32, device=None) -> Params:
    """Full (unsharded) parameters; shard with :func:`shard_mp_linear`.
    Same distribution as the JAX package (normal * sqrt(2 / d_in)), not
    the same numbers."""
    dev = resolve_device(device)
    w = torch.randn((d_in, d_out), generator=_generator(rng, dev),
                    dtype=torch.float32, device=dev) * math.sqrt(2.0 / d_in)
    return {"w": w.to(dtype), "b": torch.zeros((d_out,), dtype=dtype,
                                               device=dev)}


def shard_mp_linear(params: Params, mesh: Mesh, axis: str = AXIS_TP
                    ) -> Params:
    """This rank's shard: w input-dim-sharded, b replicated."""
    w = params["w"]
    n = w.shape[0] // mesh.shape[axis]
    return {"w": w.narrow(0, mesh.coords[axis] * n, n).clone(),
            "b": params["b"].clone()}


def make_mp_linear(mesh: Mesh, axis: str = AXIS_TP,
                   activation: Optional[Callable] = None):
    """MPLinear forward over the mesh: ``fn(params, x)`` with this rank's
    :func:`shard_mp_linear` shard and the full (batch, d_in) ``x`` (every
    rank the same), which it cuts to this rank's features; the output is
    replicated (reference MPLinear.updateOutput's allreduce completion)."""

    def fn(params, x):
        n = x.shape[-1] // mesh.shape[axis]
        x_local = x.narrow(-1, mesh.coords[axis] * n, n)
        y = row_linear(x_local, params["w"], params["b"], axis=axis,
                       mesh=mesh)
        return activation(y) if activation is not None else y

    return fn


# ------------------------------------------------- placement spec helpers

def tp_specs_linear(shard_output: bool) -> Tuple[P, P]:
    """(w_spec, b_spec) for a linear under tp: column (output-sharded) or
    row (input-sharded) layout, the specs :func:`models._common
    .shard_by_specs` places by."""
    if shard_output:
        return P(None, AXIS_TP), P(AXIS_TP)
    return P(AXIS_TP, None), P()
