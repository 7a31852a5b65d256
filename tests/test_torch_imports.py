"""The port stands alone: no module of ``torchmpi_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, a CPU generation and a
CPU ResNet training step run in a process that never loads either, and
entry points (the training examples, ``lifecycle.start`` and the ResNet
model included) refuse to fall back to the CPU when no GPU is visible and
no device was asked for."""

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


MODEL_FILES = sorted((ROOT / "torchmpi_tpu_torch" / "models").glob("*.py"))


@pytest.mark.parametrize("path", MODEL_FILES,
                         ids=[p.name for p in MODEL_FILES])
def test_models_do_not_import_the_engine(path):
    """The models sit below the engine: what the engine's GSPMD mode shares
    with batch norm lives in ``collectives/gspmd.py``."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(["torchmpi_tpu_torch"] * (node.level == 2)
                            + [node.module] * bool(node.module))
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        bad += [n for n in names
                if n.startswith("torchmpi_tpu_torch.engine")]
    assert not bad, f"models/{path.name} imports {bad}"


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


def test_resnet_engine_runs_without_jax_loaded():
    code = (
        "import sys\n"
        "from torchmpi_tpu_torch.collectives import cuda_ring, selector\n"
        "from torchmpi_tpu_torch.engine import AllReduceSGDEngine\n"
        "from torchmpi_tpu_torch.examples import train_resnet\n"
        "from torchmpi_tpu_torch.models import resnet\n"
        "from torchmpi_tpu_torch.runtime import config, lifecycle\n"
        "config.set('use_pallas_collectives', True)\n"
        "lifecycle.start(device='cpu')\n"
        "cfg = resnet.config(depth=18, n_classes=4, width_multiplier=0.125)\n"
        "p, _ = resnet.init(0, cfg, device='cpu')\n"
        "import numpy as np\n"
        "x = np.random.RandomState(0).rand(1, 2, 16, 16, 3).astype('f4')\n"
        "y = np.array([[0, 1]], dtype='i4')\n"
        "eng = AllReduceSGDEngine(resnet.make_loss_fn(cfg), lr=0.1)\n"
        "st = eng.train(p, [(x, y)])\n"
        "assert float(st['loss']) > 0\n"
        "lifecycle.stop()\n"
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


def test_train_example_raises_without_a_gpu_and_a_device(monkeypatch):
    from torchmpi_tpu_torch.examples import train_llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_llama.main(["--steps", "1"])


def test_resnet_entry_points_raise_without_a_gpu(monkeypatch, capsys):
    from torchmpi_tpu_torch.examples import train_resnet
    from torchmpi_tpu_torch.models import resnet
    from torchmpi_tpu_torch.runtime import lifecycle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = resnet.config(depth=18, n_classes=4, width_multiplier=0.125)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.init(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet.from_jax_params({"fc_b": [0.0]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lifecycle.start()
    assert not lifecycle.started()
    assert train_resnet.main(["--steps", "1"]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert train_resnet.main(["--steps", "1", "--nproc", "2"]) != 0


def test_lifecycle_starts_on_the_cpu_only_when_asked():
    import torch.distributed as dist

    from torchmpi_tpu_torch.runtime import lifecycle

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dev = lifecycle.start(device="cpu")
    try:
        assert dev.type == "cpu"
        assert dist.get_backend() == "gloo"
        assert (lifecycle.rank(), lifecycle.size()) == (0, 1)
    finally:
        lifecycle.stop()
    assert not dist.is_initialized()


def test_backend_is_nccl_only_with_a_card_per_rank(monkeypatch):
    from torchmpi_tpu_torch.runtime import lifecycle

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda", 0)
    assert lifecycle.choose_backend(cuda, 1) == "nccl"
    assert lifecycle.choose_backend(cuda, 2) == "gloo"   # ranks share a card
    assert lifecycle.choose_backend(torch.device("cpu"), 1) == "gloo"


def test_ring_never_takes_the_plain_or_cpu_form_off_the_cpu(monkeypatch):
    # A tensor that is not on the CPU goes to the kernel path's checks,
    # never to the per-rank CPU form or the plain schedule.
    from torchmpi_tpu_torch.collectives import cuda_ring

    called = []
    for name in ("_rs_steps_cpu", "_ag_steps_cpu", "_ring_allreduce_plain",
                 "_ring_reduce_scatter_plain", "_ring_allgather_plain",
                 "_oneshot_allreduce_plain", "_oneshot_reduce_scatter_plain",
                 "_oneshot_allgather_plain"):
        monkeypatch.setattr(cuda_ring, name,
                            lambda *a, **k: called.append(1))
    comm = type("C", (), {"size": 2, "rank": 0})()
    x = torch.zeros(256, device="meta")
    for fn in (cuda_ring.ring_allreduce, cuda_ring.ring_reduce_scatter,
               cuda_ring.ring_allgather):
        with pytest.raises(ValueError, match="device"):
            fn(comm, x)
    assert not called


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    # Only a CPU tensor goes to the plain version; any other device goes
    # to the kernel's checks (which refuse a non-CUDA tensor), never to
    # the plain version.
    import importlib

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    called = []
    monkeypatch.setattr(fa, "_flash_bh_plain",
                        lambda *a, **k: called.append(1))
    for name in ("_flash_bh_bwd_dq_plain", "_flash_bh_bwd_dkv_plain"):
        monkeypatch.setattr(fa, name, lambda *a, **k: called.append(1))
    q = torch.zeros(2, 8, 128, device="meta")
    row = torch.zeros(2, 8, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_block(q, q, q, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_block(q, q, q, q, row, row, causal=True)
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


def test_chip_smoke_leaves_no_process_behind(tmp_path):
    # chip_smoke.py's exit handler, registered as its main block does,
    # stops multiprocessing's resource tracker (started by a spawned
    # rank's queue) and kills a stray child: both are gone, and reaped,
    # when the script has exited.
    script = tmp_path / "run.py"
    script.write_text(
        "import atexit, subprocess, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "def put(q):\n"
        "    q.put(1)\n"
        "if __name__ == '__main__':\n"
        "    atexit.register(chip_smoke.stop_children)\n"
        "    import multiprocessing as mp\n"
        "    from multiprocessing import resource_tracker\n"
        "    ctx = mp.get_context('spawn')\n"
        "    q = ctx.Queue()\n"
        "    p = ctx.Process(target=put, args=(q,))\n"
        "    p.start()\n"
        "    assert q.get(timeout=60) == 1\n"
        "    p.join()\n"
        "    stray = subprocess.Popen(['sleep', '300'],\n"
        "                             stdout=subprocess.DEVNULL,\n"
        "                             stderr=subprocess.DEVNULL)\n"
        "    print(resource_tracker._resource_tracker._pid, stray.pid)\n")
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    tracker, stray = (int(x) for x in res.stdout.split())
    assert f"killing a leftover child, pid {stray}" in res.stderr
    assert "Traceback" not in res.stderr and "leaked" not in res.stderr
    for pid in (tracker, stray):
        assert not pathlib.Path(f"/proc/{pid}").exists()
