"""Checkpoint and resume.

Counterpart of ``torchmpi_tpu/utils/checkpoint.py``, on the same disk
layout, so a checkpoint written by either package restores in the other:
one directory per step (``step_000000123/``) holding ``leaves.npz``, the
tree's leaves keyed by their JAX tree paths (dict keys and sequence indices
joined by ``/``, the leaves in JAX order), and ``metadata.json``.  Writes go
to a temporary directory that is fsynced and then renamed into place, so a
killed process never leaves a half-checkpoint that :func:`latest_step`
would resume from.

Restore takes a *template* tree (the freshly initialised state): leaves
are matched by path, cast to the template leaf's dtype and put on its
device.  A bf16 tensor is stored as its raw 2-byte words (numpy ``'<V2'``,
the bytes the JAX writer stores for a bf16 leaf) and read back as bf16
bits; no ``ml_dtypes`` is needed.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tree as _tree

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16_WORDS = np.dtype("V2")


def _log():
    from .logging import get_logger

    return get_logger("torchmpi_tpu_torch.checkpoint")


def _fsync_path(path: Path) -> None:
    """fsync a file or directory, so its bytes (file) or entries
    (directory) survive a host power loss: the rename orders the steps,
    but a rename of never-synced data can land as a named but empty
    file."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path) or "."


def _flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    return [(_path_str(path), leaf)
            for path, leaf in _tree.flatten_with_paths(tree)]


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf``: a tensor's values (a bf16 tensor's raw
    words as ``'<V2'``), anything else through ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORDS)
        return t.numpy()
    return np.asarray(leaf)


def _like(val: np.ndarray, tleaf) -> Any:
    """``val`` in the dtype and on the device of the template leaf."""
    if isinstance(tleaf, torch.Tensor):
        t = (torch.from_numpy(val.view(np.int16).copy()).view(torch.bfloat16)
             if val.dtype == _BF16_WORDS else torch.from_numpy(np.array(val)))
        return t.to(tleaf.device, tleaf.dtype)
    if hasattr(tleaf, "dtype"):
        return val.astype(tleaf.dtype)
    return val


def _write_npz(path: Path, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez``'s container, member for member, except that a bf16
    leaf's header names its dtype ``'<V2'``, as the JAX writer's does
    (numpy would write ``'|V2'`` for plain 2-byte words)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if a.dtype == _BF16_WORDS:
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": "<V2", "fortran_order": False,
                        "shape": a.shape})
                    f.write(np.ascontiguousarray(a).tobytes())
                else:
                    np.lib.format.write_array(f, np.asanyarray(a),
                                              allow_pickle=False)


def _recover_interrupted_saves(directory: Path) -> None:
    """Finish any re-save a crash interrupted: a ``step_N.old`` whose
    ``step_N`` is missing is the complete old checkpoint moved aside before
    the new one landed, so it is renamed back; one whose ``step_N`` exists
    is residue of a completed replace and is deleted."""
    if not directory.is_dir():
        return
    for old in directory.glob("step_*.old"):
        final = old.with_name(old.name[:-len(".old")])
        try:
            if final.exists():
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(old, final)
        except OSError:
            # A concurrent reader won the rename, or the directory is
            # read-only here: recovery from read paths is best-effort, and
            # the next writer finishes it.
            pass


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` (parameters, optimizer state, any tree) at ``step``;
    device tensors are copied to the host first.  Returns the path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    _recover_interrupted_saves(directory)
    final = directory / f"step_{step:09d}"
    tmp = Path(tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory))
    try:
        _write_npz(tmp / "leaves.npz", {
            key: _to_numpy(leaf) for key, leaf in _flatten_with_paths(tree)})
        meta = {"step": step, "format": 1, **(metadata or {})}
        (tmp / "metadata.json").write_text(json.dumps(meta))
        # Durability before visibility: the payload and the directory are
        # synced before the rename publishes them.
        _fsync_path(tmp / "leaves.npz")
        _fsync_path(tmp / "metadata.json")
        _fsync_path(tmp)
        # Crash-safe re-save: an existing checkpoint moves aside before the
        # new one lands, so a kill mid-sequence never leaves the step with
        # neither copy (_recover_interrupted_saves finishes the job).
        old = final.with_name(final.name + ".old")
        shutil.rmtree(old, ignore_errors=True)
        if final.exists():
            os.replace(final, old)
        os.replace(tmp, final)
        _fsync_path(directory)
        shutil.rmtree(old, ignore_errors=True)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return str(final)


def _load_checkpoint(path: Path) -> Tuple[Dict[str, np.ndarray],
                                          Dict[str, Any]]:
    """A checkpoint directory's arrays and metadata, every member read in
    full so the zip's CRCs are checked: a torn ``leaves.npz`` raises here
    instead of handing back partial tensors."""
    with np.load(path / "leaves.npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    meta = json.loads((path / "metadata.json").read_text())
    return arrays, meta


def restore(directory: str, template: Any, step: Optional[int] = None,
            strict: bool = True) -> Tuple[Any, Dict[str, Any]]:
    """Load the checkpoint at ``step`` (default: the latest) into the
    structure of ``template``; returns ``(tree, metadata)``.

    Template leaves give dtype and device.  With ``strict=False``
    checkpoint leaves absent from the template are ignored; template
    leaves missing from the checkpoint always raise.  When the latest
    checkpoint fails to load (a host died mid-write), the newest one that
    loads is restored instead, with a warning; an explicit ``step=`` raises
    on damage."""
    _recover_interrupted_saves(Path(directory))
    if step is not None:
        path = Path(directory) / f"step_{step:09d}"
        arrays, meta = _load_checkpoint(path)
    else:
        steps = all_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        arrays = meta = path = None
        for s in reversed(steps):
            path = Path(directory) / f"step_{s:09d}"
            try:
                arrays, meta = _load_checkpoint(path)
                break
            except Exception as exc:  # torn zip, missing file, bad json
                _log().warning(
                    "checkpoint %s is unreadable (%s: %s) — falling back "
                    "to the previous step", path, type(exc).__name__, exc)
        if arrays is None:
            raise FileNotFoundError(
                f"no readable checkpoint under {directory} "
                f"(all of steps {steps} failed to load)")

    keyed = _flatten_with_paths(template)
    missing = [k for k, _ in keyed if k not in arrays]
    if missing:
        raise KeyError(f"checkpoint {path} lacks leaves {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}")
    extra = set(arrays) - {k for k, _ in keyed}
    if extra and strict:
        raise KeyError(f"checkpoint {path} has leaves not in template: "
                       f"{sorted(extra)[:5]}")
    _, treedef = _tree.flatten(template)
    return _tree.unflatten(treedef, [_like(arrays[key], tleaf)
                                     for key, tleaf in keyed]), meta


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def all_steps(directory: str) -> List[int]:
    d = Path(directory)
    if not d.is_dir():
        return []
    _recover_interrupted_saves(d)
    return sorted(int(m.group(1)) for p in d.iterdir()
                  if (m := _STEP_RE.match(p.name))
                  and (p / "metadata.json").exists())


class CheckpointManager:
    """Step-scheduled checkpointing with retention of the ``keep`` newest."""

    def __init__(self, directory: str, save_interval: int = 1000,
                 keep: int = 3):
        self.directory = str(directory)
        self.save_interval = max(1, save_interval)
        self.keep = max(1, keep)

    def should_save(self, step: int) -> bool:
        return step % self.save_interval == 0

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None) -> Optional[str]:
        path = save(self.directory, step, tree, metadata)
        self._prune()
        return path

    def maybe_save(self, step: int, tree: Any,
                   metadata: Optional[Dict[str, Any]] = None) -> Optional[str]:
        if self.should_save(step):
            return self.save(step, tree, metadata)
        return None

    def restore_latest(self, template: Any) -> Tuple[Any, Dict[str, Any]]:
        return restore(self.directory, template)

    def _prune(self) -> None:
        for s in all_steps(self.directory)[:-self.keep]:
            shutil.rmtree(Path(self.directory) / f"step_{s:09d}",
                          ignore_errors=True)


class AsyncCheckpointManager(CheckpointManager):
    """Checkpointing off the training thread.

    The device-to-host copy happens on the caller's thread, so the next
    step cannot change what is saved; serialisation, the disk writes and
    the rename run on one worker (one save in flight: a new save first
    waits for the previous one and raises its error)."""

    def __init__(self, directory: str, save_interval: int = 1000,
                 keep: int = 3):
        super().__init__(directory, save_interval=save_interval, keep=keep)
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight = None

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None) -> Optional[str]:
        snapshot = _tree.tree_map(_to_numpy, tree)
        self.wait()
        self._inflight = self._pool.submit(
            CheckpointManager.save, self, step, snapshot, metadata)
        return None   # the path is not known yet; wait() joins the write

    def wait(self) -> None:
        """Block until the in-flight save lands; its error is raised here,
        on the training thread."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def close(self) -> None:
        """Drain the in-flight save and release the worker thread."""
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _process_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def checkpoint_hooks(manager: CheckpointManager, save_process: int = 0,
                     extra: Optional[Any] = None) -> Dict[str, Any]:
    """Engine hooks that checkpoint ``{"params", "opt_state"}`` every
    ``save_interval`` steps and at ``on_end`` (the final state, unless that
    step was just saved, and a drain of an async write)::

        mgr = AsyncCheckpointManager(dir, save_interval=500)
        engine = AllReduceSGDEngine(..., hooks=checkpoint_hooks(mgr))

    ``extra`` (``state -> dict``) merges more trees into every save, e.g.
    BN running statistics.  Only rank ``save_process`` writes: the
    replicas' parameters are the same.  Under the engine's zero1 the
    optimizer state is gathered whole first (every rank takes part), so a
    checkpoint restores with zero1 or without it, as the JAX package's
    does."""
    last_saved = {"t": -1}

    def _save(state, final=False):
        opt_state = state.get("opt_state")
        engine = state.get("engine")
        if opt_state is not None and getattr(engine, "zero1", False):
            opt_state = engine.full_opt_state(opt_state, state["params"],
                                              state.get("comm"))
        last_saved["t"] = state["t"]
        if _process_rank() != save_process:
            return
        tree = {"params": state["params"]}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        if extra is not None:
            tree.update(extra(state))
        meta = {"epoch": state["epoch"], "t": state["t"]}
        if final:
            meta["final"] = True
        manager.save(state["t"], tree, metadata=meta)

    def on_update(state):
        if manager.should_save(state["t"]) and state["t"] > 0:
            _save(state)

    def on_end(state):
        if last_saved["t"] != state["t"]:
            _save(state, final=True)
        if isinstance(manager, AsyncCheckpointManager):
            manager.wait()

    return {"on_update": on_update, "on_end": on_end}


def agreed_latest_step(directory: str) -> Optional[int]:
    """The latest checkpoint step, agreed by every rank: the ranks gather
    the step each one sees (over ``torch.distributed``) and raise on
    disagreement (no shared filesystem, a late mount) instead of letting
    some resume while others start fresh.  Restore the returned step
    explicitly (``restore(..., step=...)``)."""
    import torch.distributed as dist

    step = latest_step(directory)
    if dist.is_initialized() and dist.get_world_size() > 1:
        seen: List[Optional[int]] = [None] * dist.get_world_size()
        dist.all_gather_object(seen, step)
        if len(set(seen)) != 1:
            raise RuntimeError(
                f"ranks disagree on the latest checkpoint under "
                f"{directory!r} (per-rank latest steps: {seen}): resume "
                f"needs a filesystem every rank sees")
    return step


def resume_or_init(manager: CheckpointManager, params: Any,
                   opt_state: Any = None) -> Tuple[Any, Any, int]:
    """``(params, opt_state, step)`` from the manager's latest checkpoint,
    or the given state at step 0.  The given trees are the restore
    templates (dtype and device); ``opt_state=None`` restores the
    parameters only.  Checkpoint leaves outside the template (the extras
    of ``checkpoint_hooks(extra=...)``) are ignored.  Every rank calls
    this (:func:`agreed_latest_step`)."""
    step = agreed_latest_step(manager.directory)
    if step is None:
        return params, opt_state, 0
    template = {"params": params}
    if opt_state is not None:
        template["opt_state"] = opt_state
    tree, meta = restore(manager.directory, template, step=step,
                         strict=False)
    return (tree["params"], tree.get("opt_state", opt_state),
            int(meta.get("t", meta["step"])))
