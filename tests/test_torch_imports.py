"""The port stands alone: no module of ``torchmpi_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, a CPU generation runs
in a process that never loads either, and entry points refuse to fall
back to the CPU when no GPU is visible and no device was asked for."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from torchmpi_tpu_torch.models import llama as tl
from torchmpi_tpu_torch.serving import engine as tengine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "torchmpi_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "torchmpi_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.name} imports {bad}"


def test_port_runs_without_jax_loaded():
    code = (
        "import sys\n"
        "from torchmpi_tpu_torch.models import llama\n"
        "from torchmpi_tpu_torch.serving import engine\n"
        "cfg = llama.tiny()\n"
        "p = llama.init(0, cfg, device='cpu')\n"
        "t = llama.make_generate_fn(cfg, 8, 3, device='cpu')(p, [[1]*8])\n"
        "assert tuple(t.shape) == (1, 3)\n"
        "e = engine.ServeEngine(runner=engine.LlamaRunner(2, cfg=cfg,\n"
        "    max_len=32, device='cpu'))\n"
        "r = e.submit([1, 2, 3], max_new=2)\n"
        "while not r.done.is_set(): e.iteration()\n"
        "assert r.state == 'done' and len(r.tokens) == 2\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'torchmpi_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    # Where CUDA is visible these would run on the card; decide here, in
    # the test, and make the CPU-only case the one under test.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.make_generate_fn(cfg, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_kv_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.LlamaRunner(2, cfg=cfg, max_len=32)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    # Only a CPU tensor goes to the plain version; any other device goes
    # to the kernel's checks (which refuse a non-CUDA tensor), never to
    # the plain version.
    import importlib

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    called = []
    monkeypatch.setattr(fa, "_flash_bh_plain",
                        lambda *a, **k: called.append(1))
    q = torch.zeros(2, 8, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_block(q, q, q, causal=True)
    assert not called


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    # No card: exit non-zero with no result; alone in a directory too.
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run on it")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
