"""The port's collectives tester (``torchmpi_tpu_torch/utils/tester.py``)
against the JAX package's (``tests/test_tester.py`` is the oracle): the
same volume models, the first-run checks of every collective, one config
and a small sweep in both implementations (``eager``: gloo; ``ring``: the
ring kernels' CPU form), and the fences.  One spawned pool of 2 ranks."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.utils import tester

COLLECTIVES = ["allreduce", "broadcast", "reduce", "allgather",
               "reduce_scatter", "sendreceive"]


def _setup():
    from torchmpi_tpu_torch.runtime import lifecycle

    torch.set_num_threads(1)
    lifecycle.start(device="cpu")


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(2, setup=_setup)
    yield pl
    pl.close()


@pytest.mark.parametrize("name", sorted(tester.VOLUME_MODELS))
def test_volume_models_equal_jax(name):
    from torchmpi_tpu.utils import tester as jtester

    assert set(tester.VOLUME_MODELS) == set(jtester.VOLUME_MODELS)
    for n, es, p in [(1024, 4, 8), (1000, 2, 3), (5, 4, 2), (1 << 23, 4, 4)]:
        assert tester.VOLUME_MODELS[name](n, es, p) == \
            jtester.VOLUME_MODELS[name](n, es, p)


def _check_job(coll, impl):
    from torchmpi_tpu_torch.runtime.communicator import stack

    tester.check_collective(coll, stack.current(), 64, impl=impl)
    return True


CHECK_CASES = ([(c, "eager") for c in COLLECTIVES]
               + [(c, "ring") for c in tester.RING_COLLECTIVES])


@pytest.mark.parametrize("coll,impl", CHECK_CASES,
                         ids=[f"{c}-{i}" for c, i in CHECK_CASES])
def test_check_collective(pool, coll, impl):
    assert pool.run(_check_job, coll, impl) == [True, True]


def _wrong_job():
    """A check must fail on a wrong result: allreduce reported as
    broadcast's."""
    from torchmpi_tpu_torch.runtime.communicator import stack

    comm = stack.current()
    try:
        np.testing.assert_allclose(
            tester.run_collective("allreduce", comm,
                                  torch.full((8,), float(comm.rank))).numpy(),
            tester._expected("broadcast", comm, 8))
    except AssertionError:
        return "caught"
    return "missed"


def test_a_wrong_result_fails_the_check(pool):
    assert pool.run(_wrong_job) == ["caught", "caught"]


def _one_config_job(impl, fence):
    from torchmpi_tpu_torch.runtime.communicator import stack

    r = tester.run_one_config("allreduce", stack.current(), 1 << 10,
                              warmup=2, iters=3, fence=fence, impl=impl)
    return r


@pytest.mark.parametrize("impl,fence", [("eager", "sync"), ("ring", "sync"),
                                        ("eager", "value")])
def test_run_one_config(pool, impl, fence):
    from torchmpi_tpu.utils import tester as jtester

    res = pool.run(_one_config_job, impl, fence)
    for r in res:
        assert r.p == 2 and r.checked and r.peak_hbm_bytes is None
        assert np.isfinite(r.bus_gbs) and r.bus_gbs > 0
        assert r.mean_seconds >= r.min_seconds > 0
        # Jitter as JAX draws it: the same size on both sides.
        rng = np.random.RandomState(0 + (1 << 10))
        assert r.elements == (1 << 10) + rng.randint(0, 128)
        assert 1 << 10 <= r.elements < (1 << 10) + 128
    assert res[0].elements == res[1].elements
    assert jtester.VOLUME_MODELS["allreduce"](res[0].elements, 4, 2) / \
        res[0].mean_seconds / 1e9 == pytest.approx(res[0].bus_gbs)


def _sweep_job(impl):
    from torchmpi_tpu_torch.runtime.communicator import stack

    lines = []
    res = tester.sweep(stack.current(), collectives=tester.RING_COLLECTIVES,
                       min_pow=8, max_pow=10, warmup=1, iters=2,
                       report=lines.append, impl=impl)
    return res, lines


@pytest.mark.parametrize("impl", ["eager", "ring"])
def test_sweep_small(pool, impl):
    res = pool.run(_sweep_job, impl)
    results, lines = res[0]
    assert len(results) == 9 and all(r.bus_gbs > 0 for r in results)
    # The first size of each collective is checked, the others not.
    assert [r.checked for r in results] == [True, False, False] * 3
    assert len(lines) == 9 and res[1][1] == []      # rank 0 reports
    assert all("GB/s" in ln for ln in lines)
    assert all(r.elements % 2 == 0 for r in results
               if r.collective == "reduce_scatter")


def test_fence_modes():
    x = torch.arange(4.0)
    tester._fence(x, "sync")
    tester._fence(x, "value")
    with pytest.raises(ValueError, match="fence"):
        tester._fence(x, "bogus")


def test_bad_impl_and_collective_raise():
    comm = type("C", (), {"size": 2, "rank": 0})()
    with pytest.raises(ValueError, match="impl"):
        tester.run_collective("allreduce", comm, torch.zeros(4), impl="xla")
    with pytest.raises(ValueError, match="ring"):
        tester.run_collective("broadcast", comm, torch.zeros(4), impl="ring")
    with pytest.raises(ValueError, match="unknown"):
        tester.run_collective("scatter", comm, torch.zeros(4))
    assert tester.peak_hbm_bytes("cpu") is None
