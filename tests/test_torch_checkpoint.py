"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's.

The counterparts of ``tests/test_checkpoint.py`` (round trip, latest and
explicit step, dtype cast, strict and non-strict restore, the torn-latest
fallback, ``.old`` recovery, retention, the async manager's error), then
the two packages on one disk layout: a tree the JAX ``save`` writes
restores in the port, and one the port writes restores in the JAX package,
f32 and int32 leaves in nested dicts and lists, with the same keys and the
same bytes.  A bf16 leaf the port writes has the JAX writer's bytes
(``'<V2'`` words) and restores in the port.  Every comparison is exact.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.utils import checkpoint as ckpt


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"params": {"w": torch.from_numpy(rng.randn(4, 3).astype("f4")),
                       "b": torch.from_numpy(rng.randn(3).astype("f4"))},
            "stats": [torch.arange(5, dtype=torch.int32),
                      {"n": torch.tensor(7, dtype=torch.int32)}]}


def _zeros_like(tree):
    from torchmpi_tpu_torch.utils import tree as ttree

    return ttree.tree_map(torch.zeros_like, tree)


def _equal(a, b):
    from torchmpi_tpu_torch.utils import tree as ttree

    la, lb = ttree.leaves(a), ttree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    tree = _tree()
    path = ckpt.save(tmp_path, 5, tree, metadata={"epoch": 1})
    assert os.path.basename(path) == "step_000000005"
    out, meta = ckpt.restore(tmp_path, _zeros_like(tree))
    _equal(out, tree)
    assert meta == {"step": 5, "format": 1, "epoch": 1}


def test_latest_and_explicit_step(tmp_path):
    for s in (1, 3, 2):
        ckpt.save(tmp_path, s, _tree(s))
    assert ckpt.latest_step(tmp_path) == 3
    assert ckpt.all_steps(tmp_path) == [1, 2, 3]
    _equal(ckpt.restore(tmp_path, _zeros_like(_tree()))[0], _tree(3))
    _equal(ckpt.restore(tmp_path, _zeros_like(_tree()), step=2)[0], _tree(2))
    assert ckpt.latest_step(tmp_path / "nope") is None


def test_dtype_cast_to_template(tmp_path):
    ckpt.save(tmp_path, 0, {"w": torch.tensor([1.5, -2.25, 3.0])})
    out, _ = ckpt.restore(tmp_path, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    assert out["w"].tolist() == [1.5, -2.25, 3.0]
    out, _ = ckpt.restore(tmp_path, {"w": torch.zeros(3, dtype=torch.int32)})
    assert out["w"].tolist() == [1, -2, 3]


def test_strict_and_partial_restore(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 0, tree)
    with pytest.raises(KeyError, match="not in template"):
        ckpt.restore(tmp_path, {"params": _zeros_like(tree["params"])})
    out, _ = ckpt.restore(tmp_path, {"params": _zeros_like(tree["params"])},
                          strict=False)
    _equal(out["params"], tree["params"])
    with pytest.raises(KeyError, match="lacks leaves"):
        ckpt.restore(tmp_path, {**_zeros_like(tree), "extra": torch.zeros(1)})


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "nope", _tree())


def _tear(path):
    npz = path / "leaves.npz"
    data = npz.read_bytes()
    npz.write_bytes(data[:len(data) // 2])


def test_torn_latest_falls_back_but_explicit_step_raises(tmp_path):
    ckpt.save(tmp_path, 1, _tree(1))
    ckpt.save(tmp_path, 2, _tree(2))
    _tear(tmp_path / "step_000000002")
    _equal(ckpt.restore(tmp_path, _zeros_like(_tree()))[0], _tree(1))
    with pytest.raises(Exception):
        ckpt.restore(tmp_path, _zeros_like(_tree()), step=2)
    _tear(tmp_path / "step_000000001")
    with pytest.raises(FileNotFoundError, match="no readable checkpoint"):
        ckpt.restore(tmp_path, _zeros_like(_tree()))


def test_old_dir_recovery(tmp_path):
    # A crash after the old copy moved aside and before the new one
    # landed: the .old directory is renamed back.
    ckpt.save(tmp_path, 4, _tree(4))
    os.replace(tmp_path / "step_000000004", tmp_path / "step_000000004.old")
    assert ckpt.latest_step(tmp_path) == 4
    assert not (tmp_path / "step_000000004.old").exists()
    # Residue of a completed replace is deleted; a re-save replaces.
    ckpt.save(tmp_path, 4, _tree(5))
    (tmp_path / "step_000000004.old").mkdir()
    assert ckpt.all_steps(tmp_path) == [4]
    assert not (tmp_path / "step_000000004.old").exists()
    _equal(ckpt.restore(tmp_path, _zeros_like(_tree()))[0], _tree(5))


def test_manager_interval_and_retention(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, save_interval=2, keep=2)
    for s in range(1, 9):
        mgr.maybe_save(s, _tree(s))
    assert ckpt.all_steps(tmp_path) == [6, 8]
    _equal(mgr.restore_latest(_zeros_like(_tree()))[0], _tree(8))


def test_async_manager_writes_and_raises_its_error(tmp_path):
    with ckpt.AsyncCheckpointManager(tmp_path / "sub", save_interval=1) as m:
        tree = _tree()
        m.save(1, tree)
        tree["params"]["w"].add_(1.0)   # the snapshot was taken already
        m.wait()
        _equal(ckpt.restore(tmp_path / "sub", _zeros_like(tree))[0], _tree())
        m.directory = "/proc/definitely/not/writable"
        m.save(2, tree)
        with pytest.raises(Exception):
            m.wait()


def test_hooks_save_on_schedule_and_at_the_end(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, save_interval=3)
    hooks = ckpt.checkpoint_hooks(mgr, extra=lambda s: {"extra": s["x"]})
    for t in range(1, 8):
        state = {"params": {"w": torch.full((2,), float(t))},
                 "opt_state": None, "epoch": 0, "t": t,
                 "x": torch.tensor([t])}
        hooks["on_update"](state)
    hooks["on_end"](state)
    assert ckpt.all_steps(tmp_path) == [3, 6, 7]
    meta = json.loads((tmp_path / "step_000000007" / "metadata.json")
                      .read_text())
    assert meta == {"step": 7, "format": 1, "epoch": 0, "t": 7, "final": True}
    params, _, t0 = ckpt.resume_or_init(mgr, {"w": torch.zeros(2)})
    assert t0 == 7 and params["w"].tolist() == [7.0, 7.0]
    fresh, _, t1 = ckpt.resume_or_init(
        ckpt.CheckpointManager(tmp_path / "empty"), {"w": torch.ones(2)})
    assert t1 == 0 and fresh["w"].tolist() == [1.0, 1.0]


# ------------------------------------------------------- across the packages

def _np_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(3, 2).astype(np.float32),
                  "i": np.arange(4, dtype=np.int32)},
            "b": [rng.randn(5).astype(np.float32),
                  {"c": np.array([7, -1], dtype=np.int32)}]}


def _members(path):
    with zipfile.ZipFile(path / "leaves.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    import jax

    from torchmpi_tpu.utils import checkpoint as jckpt

    want = _np_tree(1)
    jckpt.save(tmp_path, 12, jax.tree.map(jax.numpy.asarray, want),
               metadata={"t": 12})
    template = {"a": {"w": torch.zeros(3, 2), "i": torch.zeros(
        4, dtype=torch.int32)}, "b": [torch.zeros(5), {"c": torch.zeros(
            2, dtype=torch.int32)}]}
    out, meta = ckpt.restore(tmp_path, template)
    assert meta["t"] == 12
    _equal(out, jax.tree.map(torch.from_numpy, want))


def test_port_checkpoint_restores_in_jax_with_the_same_bytes(tmp_path):
    import jax

    from torchmpi_tpu.utils import checkpoint as jckpt

    want = _np_tree(2)
    ckpt.save(tmp_path / "port", 3, jax.tree.map(torch.from_numpy, want))
    jckpt.save(tmp_path / "jax", 3, want)
    port = _members(tmp_path / "port" / "step_000000003")
    assert port == _members(tmp_path / "jax" / "step_000000003")
    assert sorted(port) == ["a/i.npy", "a/w.npy", "b/0.npy", "b/1/c.npy"]
    out, _ = jckpt.restore(tmp_path / "port",
                           jax.tree.map(np.zeros_like, want))
    for x, y in zip(jax.tree.leaves(out), jax.tree.leaves(want)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_bf16_leaf_has_the_jax_writers_bytes_and_restores(tmp_path):
    import jax.numpy as jnp

    from torchmpi_tpu.utils import checkpoint as jckpt

    vals = [0.0, 1.5, -3.25, 1e-3, 65504.0, float("inf")]
    t = torch.tensor(vals, dtype=torch.bfloat16)
    ckpt.save(tmp_path / "port", 1, {"w": t})
    jckpt.save(tmp_path / "jax", 1, {"w": jnp.asarray(vals, jnp.bfloat16)})
    port = _members(tmp_path / "port" / "step_000000001")
    assert port == _members(tmp_path / "jax" / "step_000000001")
    with np.load(tmp_path / "port" / "step_000000001" / "leaves.npz") as z:
        assert z["w"].dtype == np.dtype("V2")
    out, _ = ckpt.restore(tmp_path / "port",
                          {"w": torch.zeros(6, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), t.view(torch.int16))
