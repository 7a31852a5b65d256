"""The program registry the compiled autotune pass times.

Counterpart of the ``PROGRAMS`` registry of
``torchmpi_tpu/runtime/topology.py``: the two programs the compiled pass
defaults to (its ``_build_llama_dp_tp`` and ``_build_1f1b`` on the
combined schedule).  Each builder returns ``(fn, args)``: this rank's step of
the program over the port's mesh paths in the running world, and its
arguments, so that ``fn(*args)`` runs one step and returns its loss.  Every
rank of the world calls a builder at the same point (it makes the mesh's
process groups) and then runs the step at the same points.

The JAX module's named fabrics (``topology_devices``, ``topology_mesh``),
``dryrun_topology`` and the AOT compile record compile for TPU slices a
host does not own; they are ROADMAP item 20 and raise
:class:`NamedFabricUnavailable` here.

Every build draws its parameters and batch afresh from ``seed``
(:func:`program_inputs`), so each variant's first step starts from the
same weights as every other's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


class NamedFabricUnavailable(RuntimeError):
    """A named fabric (``"v5e-8"``, ``"v4-32"``) was asked for: the port
    has no compile-only device path (ROADMAP item 20)."""


def topology_devices(topology: str):
    raise NamedFabricUnavailable(
        f"named fabric {topology!r}: runtime/topology.py's named fabrics, "
        f"dryrun_topology and the AOT record are ROADMAP item 20; the port "
        f"builds and times its programs on the running world only")


def _world_size() -> int:
    from . import lifecycle

    if not lifecycle.started():
        raise RuntimeError("a program builds over the running world: call "
                           "start() on every rank first")
    return lifecycle.size()


def program_inputs(cfg, B: int, L: int, dtype, seed: int, device=None):
    """The whole model drawn from ``seed`` and the global (B, L) batch,
    ``(params, tokens, targets)``, the same on every rank."""
    from ..models import llama

    dev = device if device is not None else _device()
    g = torch.Generator(device=dev).manual_seed(seed)
    whole = llama.init(g, cfg, dtype=dtype, device=dev)
    tok = torch.randint(0, cfg.vocab, (B, L + 1), generator=g, device=dev)
    return whole, tok[:, :-1].contiguous(), tok[:, 1:].contiguous()


def _device():
    from . import lifecycle

    return lifecycle.device()


def _inputs(cfg, mesh, shard_fn, B: int, L: int, dtype, seed: int):
    """This rank's shard of :func:`program_inputs`' model and the global
    batch."""
    whole, tokens, targets = program_inputs(cfg, B, L, dtype, seed)
    params = shard_fn(whole, mesh, cfg)
    del whole
    return params, tokens, targets


def _build_llama_dp_tp(topology: Optional[str] = None, cfg=None,
                       batch: Optional[int] = None, seq: int = 32,
                       dtype=torch.float32, loss_chunk: Optional[int] = None,
                       seed: int = 0) -> Tuple[Callable, Tuple]:
    """The dp x tp Llama training step (config 5's layout, tp 2) with
    remat "dots", the chunked loss and flash attention; JAX's builder at
    ``llama.tiny()`` and (B, L) = (max(2, n / 2) * 2, 32) by default."""
    if topology is not None:
        topology_devices(topology)
    from ..models import llama
    from ..parallel import mesh as mesh_mod

    n = _world_size()
    cfg = cfg or llama.tiny()
    mesh = mesh_mod.make_mesh({"dp": -1, "tp": 2})
    B = batch or max(2, n // 2) * 2
    step = llama.make_train_step(cfg, mesh, lr=0.1, attn="flash",
                                 remat="dots",
                                 loss_chunk=loss_chunk or seq // 2)
    args = _inputs(cfg, mesh, llama.shard_params, B, seq, dtype, seed)

    def fn(params, tokens, targets):
        return step(params, None, tokens, targets)[2]

    return fn, args


def _build_1f1b(topology: Optional[str], manual_schedule: str, cfg=None,
                batch: Optional[int] = None, seq: int = 32,
                dtype=torch.float32, loss_chunk: Optional[int] = None,
                seed: int = 0, n_microbatches: int = 4
                ) -> Tuple[Callable, Tuple]:
    """The dp x pp x tp Llama step on the 1F1B schedule with the
    hand-sharded (manual-tp) flash stage (pp 2, tp 2): the program whose
    gradient sums the wire knob steers."""
    if topology is not None:
        topology_devices(topology)
    from ..models import llama
    from ..parallel import mesh as mesh_mod

    n = _world_size()
    cfg = cfg or llama.tiny()
    mesh = mesh_mod.make_mesh({"dp": -1, "pp": 2, "tp": 2})
    B = batch or max(2, n // 2) * 2
    step, _ = llama.make_1f1b_train_step(
        cfg, mesh, n_microbatches=n_microbatches, lr=0.05, attn="flash",
        loss_chunk=loss_chunk or seq // 2, stage_tp="manual",
        manual_schedule=manual_schedule)
    args = _inputs(cfg, mesh, llama.shard_params_pp, B, seq, dtype, seed)

    def fn(params, tokens, targets):
        return step(params, tokens, targets)[1]

    return fn, args


# Registry: label -> builder(topology, **kw), under JAX's labels.
PROGRAMS: Dict[str, Callable[..., Tuple[Callable, Tuple]]] = {
    "llama_dp_tp_step": _build_llama_dp_tp,
    "1f1b_manual_tp_combined":
        lambda t=None, **kw: _build_1f1b(t, "combined", **kw),
}
