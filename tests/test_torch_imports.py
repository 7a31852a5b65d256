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


HIERARCHY_RANK = """
import sys
import torch
import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch.collectives import hierarchical, hostcomm
import torch.distributed as dist

mpi.config.set("use_tree_communicators", True)
mpi.config.set("use_cartesian_communicators", False)
mpi.start(device="cpu")
me = mpi.rank()
mpi.push_communicator(lambda r: r)          # two groups of one: a tree
x = torch.full((6,), float(me + 1))
tree = hierarchical.allreduce_tree(mpi.stack.current(), x)
mpi.set_collective_span(0, 2)
flat = mpi.allreduce(x)
eps = [None, None]
dist.all_gather_object(eps, ("127.0.0.1", hostcomm.free_ports(1)[0]))
ring = hostcomm.HostCommunicator(me, 2, eps, timeout_ms=60000,
                                 io_deadline_ms=20000)
host = ring.allreduce(x.clone())
ring.close()
mpi.stop()
assert tree.tolist() == flat.tolist() == host.tolist() == [3.0] * 6
loaded = [m for m in sys.modules if m.split('.')[0] in
          ('jax', 'jaxlib', 'torchmpi_tpu')]
assert not loaded, loaded
print('ok')
"""


def test_hierarchy_and_host_ring_run_without_jax_loaded(tmp_path):
    """Two processes of a gloo world: a tree allreduce over a pushed split,
    the flat one under the span over both levels, and a host ring wired
    from endpoints gathered over the world, with neither JAX nor the JAX
    package loaded."""
    _run_two_ranks(tmp_path, HIERARCHY_RANK)


MESH_RANK = """
import sys
import torch
import torchmpi_tpu_torch as mpi
from torchmpi_tpu_torch import parallel
from torchmpi_tpu_torch.collectives import innerjit
from torchmpi_tpu_torch.models import llama
from torchmpi_tpu_torch.parallel import sequence, tp

mpi.start(device="cpu")
mesh = parallel.make_mesh({"sp": 2})
cfg = llama.tiny()
params = llama.shard_params(llama.init(0, cfg, device="cpu"), mesh, cfg)
tokens = torch.randint(0, cfg.vocab, (1, 17), generator=torch.Generator().manual_seed(0))
step = llama.make_train_step(cfg, mesh, lr=0.1, attn="ring")
_, _, loss = step(params, None, tokens[:, :-1], tokens[:, 1:])
x = torch.full((3,), float(mpi.rank() + 1))
shifted = innerjit.ring_shift(x, "sp", mesh=mesh)
me = mpi.rank()
pp = parallel.make_mesh({"pp": 2})
whole = llama.init(0, cfg, device="cpu")
gpipe, V = llama.make_pp_train_step(cfg, pp, 1, lr=0.1)
_, loss_pp = gpipe(llama.shard_params_pp(whole, pp, cfg), tokens[:, :-1],
                   tokens[:, 1:])
one_f_one_b, _ = llama.make_1f1b_train_step(cfg, pp, 1, lr=0.1)
_, loss_1f1b = one_f_one_b(llama.shard_params_pp(whole, pp, cfg),
                           tokens[:, :-1], tokens[:, 1:])
mpi.stop()
assert torch.isfinite(loss) and shifted.tolist() == [float(2 - me)] * 3
assert V == 1 and abs(float(loss_pp) - float(loss_1f1b)) < 1e-5
loaded = [m for m in sys.modules if m.split('.')[0] in
          ('jax', 'jaxlib', 'torchmpi_tpu')]
assert not loaded, loaded
print('ok')
"""


def test_mesh_paths_run_without_jax_loaded(tmp_path):
    """Two processes of a gloo world: the mesh modules (``parallel.mesh``,
    ``tp``, ``sequence``, ``pipeline``, ``collectives.innerjit``) import,
    Llama's ring-attention train step and a ring shift run over an {sp 2}
    mesh, and a GPipe step and a 1F1B step over a {pp 2} mesh (the same
    loss from the same weights), with neither JAX nor the JAX package
    loaded."""
    _run_two_ranks(tmp_path, MESH_RANK)


def _run_two_ranks(tmp_path, source):
    import os

    from torchmpi_tpu_torch.runtime import launch

    script = tmp_path / "rank.py"
    script.write_text(source)
    port = launch.free_port()
    procs = []
    for r in range(2):
        env = {**os.environ, "PYTHONPATH": str(ROOT),
               **launch._rank_env(r, 2, port)}
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], cwd=tmp_path, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [pr.communicate(timeout=120) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for pr, (out, err) in zip(procs, outs):
        assert pr.returncode == 0, err
        assert out.strip() == "ok"


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


SLICE16_MODULES = ["parallel/moe.py", "parameterserver/__init__.py",
                   "parameterserver/native.py", "parameterserver/placement.py",
                   "parameterserver/update.py", "obs/native.py",
                   "obs/flight.py", "examples/mnist_modelparallel.py",
                   "examples/mnist_parameterserver.py",
                   "examples/mnist_parameterserver_easgd_dataparallel.py"]


@pytest.mark.parametrize("rel", SLICE16_MODULES)
def test_slice16_modules_are_checked(rel):
    """The import check above covers the MoE, parameter-server and
    observability modules of the port."""
    assert ROOT / "torchmpi_tpu_torch" / rel in PORT_FILES


def test_ps_engine_is_the_ports_own_copy():
    """``ps.cpp`` (and the headers it includes) are the port's copies, byte
    for byte the JAX package's, and the library loads from the port's own
    build directory."""
    from torchmpi_tpu_torch._native import build
    from torchmpi_tpu_torch.parameterserver import native

    for name in ("ps.cpp", "bf16.h", "crc32.h", "trace.h"):
        ours = ROOT / "torchmpi_tpu_torch" / "_native" / name
        theirs = ROOT / "torchmpi_tpu" / "_native" / name
        assert ours.read_bytes() == theirs.read_bytes(), name
    native.lib()
    path = build.library_path("tmpi_ps", ["ps.cpp"])
    assert path.exists() and path.parent == build.BUILD_DIR
    assert build.BUILD_DIR == ROOT / "torchmpi_tpu_torch" / "_native" / "_build"


def test_moe_and_parameterserver_run_without_jax_loaded():
    code = (
        "import sys, torch\n"
        "from torchmpi_tpu_torch.models import llama\n"
        "from torchmpi_tpu_torch import parameterserver as ps\n"
        "from torchmpi_tpu_torch.parameterserver import native\n"
        "from torchmpi_tpu_torch.parameterserver.update import "
        "DownpourUpdate\n"
        "from torchmpi_tpu_torch.obs import flight\n"
        "cfg = llama.moe_tiny()\n"
        "p = llama.init(0, cfg, device='cpu')\n"
        "t = llama.make_generate_fn(cfg, 8, 3, device='cpu')(p, [[1]*8])\n"
        "assert tuple(t.shape) == (1, 3)\n"
        "L = native.lib()\n"
        "sid = L.tmpi_ps_server_start(0)\n"
        "ps.init_cluster(endpoints=[('127.0.0.1', "
        "L.tmpi_ps_server_port(sid))], start_server=False)\n"
        "x = ps.init(torch.ones(5))\n"
        "ps.send(x, torch.ones(5)).wait()\n"
        "h, out = ps.receive(x)\n"
        "assert h.wait().tolist() == [2.0] * 5\n"
        "ps.shutdown()\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'torchmpi_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["mnist_modelparallel",
                                  "mnist_parameterserver",
                                  "mnist_parameterserver_easgd_dataparallel"])
def test_slice16_examples_refuse_the_cpu_unless_asked(monkeypatch, capsys,
                                                      name):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = importlib.import_module(f"torchmpi_tpu_torch.examples.{name}")
    assert ex.main([]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_moe_entry_points_raise_without_a_gpu(monkeypatch):
    from torchmpi_tpu_torch.parallel import moe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        moe.init_experts(0, 4, 8, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init(0, tl.moe_tiny())


SLICE17_MODULES = ["parallel/pipeline.py", "parallel/blocks.py",
                   "examples/mnist_pipeline.py"]


@pytest.mark.parametrize("rel", SLICE17_MODULES)
def test_slice17_modules_are_checked(rel):
    """The import check above covers the pipeline modules of the port and
    config 4's example."""
    assert ROOT / "torchmpi_tpu_torch" / rel in PORT_FILES


def test_pipeline_entry_points_raise_without_a_gpu(monkeypatch, capsys):
    """Config 4's example, ``train_llama --pp`` and ``BlockSequential.init``
    refuse to fall back to the CPU when no GPU is visible and no device was
    asked for."""
    from torchmpi_tpu_torch.examples import mnist_pipeline, train_llama
    from torchmpi_tpu_torch.parallel import blocks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mnist_pipeline.main([]) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mnist_pipeline.run(mnist_pipeline.parse_args([]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_llama.main(["--pp", "2", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blocks.BlockSequential([]).init(0)


SLICE18_MODULES = ["models/vit.py"]


@pytest.mark.parametrize("rel", SLICE18_MODULES)
def test_slice18_modules_are_checked(rel):
    """The import check above covers the port's ViT."""
    assert ROOT / "torchmpi_tpu_torch" / rel in PORT_FILES


def test_vit_runs_without_jax_loaded():
    code = (
        "import sys, torch\n"
        "from torchmpi_tpu_torch.models import vit\n"
        "cfg = vit.tiny()\n"
        "p = vit.init(0, cfg, device='cpu')\n"
        "x = torch.randn(2, 32, 32, 3)\n"
        "loss = vit.make_loss_fn(cfg, attn='flash', remat='dots')(\n"
        "    p, (x, torch.tensor([1, 2])))\n"
        "assert torch.isfinite(loss)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'torchmpi_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


SLICE19_MODULES = ["obs/metrics.py", "obs/serve.py", "obs/export.py",
                   "obs/clocksync.py", "obs/aggregate.py", "obs/history.py",
                   "obs/alerts.py", "serving/frontend.py",
                   "serving/router.py"]


@pytest.mark.parametrize("rel", SLICE19_MODULES)
def test_slice19_modules_are_checked(rel):
    """The import check above covers the telemetry plane and the serving
    frontend and router of the port."""
    assert ROOT / "torchmpi_tpu_torch" / rel in PORT_FILES


def test_serving_http_runs_without_jax_loaded():
    """A port replica behind its frontend and obs endpoint, and a router
    over it, answer over loopback in a process that never loads JAX or
    the JAX package."""
    code = (
        "import json, sys, urllib.request\n"
        "from torchmpi_tpu_torch.obs import metrics, serve\n"
        "from torchmpi_tpu_torch.serving import (ServeFrontend, "
        "ServeRouter, engine)\n"
        "reg = metrics.Registry()\n"
        "health = serve.HealthState()\n"
        "eng = engine.ServeEngine(runner=engine.StubRunner(2),\n"
        "                         registry=reg).start()\n"
        "obs = serve.ObsHTTPServer(registry=reg, health=health)\n"
        "front = ServeFrontend(eng, health=health)\n"
        "try:\n"
        "    router = ServeRouter({0: front.url}, {0: obs.url}, timeout=10)\n"
        "    assert router.probe() == {0: 'healthy'}\n"
        "    code, doc = router.dispatch('k', {'prompt': [1, 2],\n"
        "                                      'max_new': 3})\n"
        "    assert code == 200 and len(doc['tokens']) == 3, doc\n"
        "    with urllib.request.urlopen(obs.url + '/metrics',\n"
        "                                timeout=10) as r:\n"
        "        assert b'tmpi_serve_requests_total' in r.read()\n"
        "finally:\n"
        "    front.close()\n"
        "    obs.close()\n"
        "    eng.stop()\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'torchmpi_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


SLICE20_MODULES = ["runtime/failure.py", "runtime/chaos.py",
                   "runtime/resize.py", "runtime/election.py", "obs/rca.py",
                   "examples/mnist_elastic.py", "tools/elastic_drill.py"]


@pytest.mark.parametrize("rel", SLICE20_MODULES)
def test_slice20_modules_are_checked(rel):
    """The import check above covers failure and membership, the
    root-cause reader and the elastic example and drill."""
    assert ROOT / "torchmpi_tpu_torch" / rel in PORT_FILES


def test_failure_and_membership_load_without_jax():
    """Importing the slice's modules in a fresh interpreter loads neither
    JAX nor the JAX package."""
    code = (
        "import sys\n"
        "import torchmpi_tpu_torch.runtime.failure\n"
        "import torchmpi_tpu_torch.runtime.chaos\n"
        "import torchmpi_tpu_torch.runtime.resize\n"
        "import torchmpi_tpu_torch.runtime.election\n"
        "import torchmpi_tpu_torch.obs.rca\n"
        "import torchmpi_tpu_torch.examples.mnist_elastic\n"
        "import torchmpi_tpu_torch.tools.elastic_drill\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'torchmpi_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_elastic_example_refuses_the_cpu_unless_asked(monkeypatch, capsys):
    from torchmpi_tpu_torch.examples import mnist_elastic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mnist_elastic.main(["--nproc", "4"]) == 2
    assert "--device cpu" in capsys.readouterr().err


SLICE21_MODULES = ["obs/numerics.py", "obs/cluster.py", "obs/__main__.py",
                   "tools/numerics_drill.py", "utils/tester.py"]


@pytest.mark.parametrize("rel", SLICE21_MODULES)
def test_slice21_modules_are_checked(rel):
    """The import check above covers the numerics plane, cluster
    federation, the obs CLI, the numerics drill and the tester's
    ``mfu_sweep``."""
    assert ROOT / "torchmpi_tpu_torch" / rel in PORT_FILES


def test_numerics_plane_and_cli_run_without_jax_loaded():
    """The slice's modules import, and the CLI's ``snapshot`` runs, in a
    fresh interpreter that loads neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "import torchmpi_tpu_torch.obs.numerics\n"
        "import torchmpi_tpu_torch.obs.cluster\n"
        "import torchmpi_tpu_torch.tools.numerics_drill\n"
        "from torchmpi_tpu_torch.obs import __main__ as cli\n"
        "from torchmpi_tpu_torch.utils import tester\n"
        "assert cli.main(['snapshot']) == 0\n"
        "assert callable(tester.mfu_sweep)\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'torchmpi_tpu')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_cli_drill_and_mfu_sweep_raise_without_a_gpu(monkeypatch):
    from torchmpi_tpu_torch.obs import __main__ as cli
    from torchmpi_tpu_torch.tools import numerics_drill
    from torchmpi_tpu_torch.utils import tester

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tester.mfu_sweep((1,), ("none",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["drill", "--numerics", "--quick"])
    assert numerics_drill.main([]) == 2
