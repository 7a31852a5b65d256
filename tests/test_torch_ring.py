"""The port's ring collectives (``collectives/cuda_ring.py``) against the JAX
package's ``pallas_ring``.

* ``_geometry`` and ``_nslots`` equal JAX's over a grid of sizes, rank
  counts, item sizes and buffer knobs.
* The plain schedule (``_ring_*_plain``, all ranks in one process) equals
  ``pallas_ring.ring_allreduce`` / ``ring_reduce_scatter`` /
  ``ring_allgather`` run in interpret mode on p of the 8 virtual CPU devices
  **bit for bit**, in f32, bf16 (random values) and int32, with sub-chunks
  and with one staging slot: the same chunks summed in the same order in
  the wire dtype leave no room for any difference, so the test asks for
  exact equality, not a tolerance.
* The per-rank CPU form (send/recv of chunks over a gloo world, one pool of
  4 spawned ranks for the module) equals the plain schedule, also exactly.
* On a GPU (``cuda`` marker) the kernels equal the plain schedule exactly.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.collectives import cuda_ring
from torchmpi_tpu_torch.runtime import config as tconfig

KNOBS = {
    "default": {},
    "subchunks": {"max_buffer_size": 1 << 10, "min_buffer_size": 1 << 9},
    "one_slot": {"num_buffers_per_collective": 1,
                 "max_buffer_size": 1 << 12, "min_buffer_size": 1 << 16},
    "many_slots": {"num_buffers_per_collective": 9,
                   "max_num_buffers_per_collective_tpu": 5},
}


@pytest.fixture()
def both_configs():
    from torchmpi_tpu.runtime import config as jconfig

    jconfig.reset()
    tconfig.reset()
    yield jconfig
    jconfig.reset()
    tconfig.reset()


def _set(jconfig, knobs):
    jconfig.reset(**knobs)
    tconfig.reset(**knobs)


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("itemsize", [2, 4])
def test_geometry_matches_jax(both_configs, knobs, itemsize):
    from torchmpi_tpu.collectives import pallas_ring

    _set(both_configs, KNOBS[knobs])
    for n in (0, 1, 5, 127, 128, 129, 3000, 65536, 1_000_003, 25_557_032):
        for p in (1, 2, 3, 4, 8):
            assert (cuda_ring._geometry(n, p, itemsize)
                    == pallas_ring._geometry(n, p, itemsize)), (n, p)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_nslots_matches_jax(both_configs, knobs):
    from torchmpi_tpu.collectives import pallas_ring

    _set(both_configs, KNOBS[knobs])
    for p in range(1, 9):
        assert cuda_ring._nslots(p) == pallas_ring._nslots(p), p


# ------------------------------------------------- values shared by both sides

def _values(kind: str, dtype: str, p: int, n: int, seed: int) -> np.ndarray:
    """(p, n) random values; bf16 as ml_dtypes.bfloat16."""
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(-1000, 1000, size=(p, n)).astype(np.int32)
    vals = rng.randn(p, n).astype(np.float32)
    return vals.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else vals


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(a) -> np.ndarray:
    """Exact bit pattern of a numpy array or tensor."""
    if isinstance(a, torch.Tensor):
        a = (a.contiguous().view(torch.int16) if a.dtype == torch.bfloat16
             else a.contiguous()).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _plain(kind: str, xs):
    return {"allreduce": cuda_ring._ring_allreduce_plain,
            "reduce_scatter": cuda_ring._ring_reduce_scatter_plain,
            "allgather": cuda_ring._ring_allgather_plain}[kind](xs)


# (kind, dtype, p, n, knobs): every kernel in f32 and bf16 (allreduce in
# int32 too), at p = 2 and 4, with sub-chunks and with one slot.
JAX_CASES = [
    ("allreduce", "float32", 2, 3000, "default"),
    ("allreduce", "bfloat16", 4, 3000, "subchunks"),
    ("allreduce", "int32", 4, 1000, "one_slot"),
    ("allreduce", "bfloat16", 2, 700, "one_slot"),
    ("reduce_scatter", "bfloat16", 2, 3000, "subchunks"),
    ("reduce_scatter", "float32", 4, 2000, "one_slot"),
    ("allgather", "float32", 2, 300, "one_slot"),
    ("allgather", "bfloat16", 4, 260, "subchunks"),
]


@pytest.mark.parametrize("kind,dtype,p,n,knobs", JAX_CASES,
                         ids=["-".join(map(str, c)) for c in JAX_CASES])
def test_plain_schedule_equals_jax_interpret_bit_for_bit(
        both_configs, kind, dtype, p, n, knobs):
    import jax

    from torchmpi_tpu.collectives import eager, pallas_ring
    from torchmpi_tpu.runtime.communicator import Communicator

    _set(both_configs, KNOBS[knobs])
    pallas_ring.clear_cache()
    assert pallas_ring.RING_KERNELS_AVAILABLE
    vals = _values(kind, dtype, p, n, seed=JAX_CASES.index(
        (kind, dtype, p, n, knobs)))
    comm = Communicator(jax.devices()[:p])
    x = eager.shard(comm, vals)
    ref = {"allreduce": pallas_ring.ring_allreduce,
           "reduce_scatter": pallas_ring.ring_reduce_scatter,
           "allgather": pallas_ring.ring_allgather}[kind](comm, x)
    ref = np.asarray(jax.device_get(ref))
    got = _plain(kind, [_to_torch(v) for v in vals])
    for r in range(p):
        np.testing.assert_array_equal(_bits(got[r]), _bits(ref[r]))
    pallas_ring.clear_cache()


def test_bf16_running_sum_rounds_after_every_add():
    """The wire-dtype rule and the chunk order, visibly.  Ranks hold 1, 256,
    1, 1 (bf16 spacing is 2 above 256); 256 elements at p = 4 make two
    chunks of 128 and two of padding.  Chunk 0 sums from rank 1: 256 + 1
    rounds to 256, and stays there; chunk 1 sums from rank 2: 1 + 1 + 1 +
    256 = 259, which rounds to 260.  An f32 sum would give 259 everywhere."""
    xs = [torch.tensor([v] * 256, dtype=torch.bfloat16)
          for v in (1.0, 256.0, 1.0, 1.0)]
    for out in cuda_ring._ring_allreduce_plain(xs):
        assert out.float().tolist() == [256.0] * 128 + [260.0] * 128


def test_mean_divides_in_the_wire_dtype():
    xs = [torch.full((10,), float(r), dtype=torch.bfloat16) for r in range(4)]
    out = cuda_ring._ring_allreduce_plain(xs, mean=True)
    assert out[0].dtype == torch.bfloat16
    assert out[0].float().tolist() == [1.5] * 10


def test_argument_errors():
    comm = type("C", (), {"size": 2, "rank": 0})()
    with pytest.raises(ValueError, match="flat"):
        cuda_ring.ring_allreduce(comm, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="sum"):
        cuda_ring.ring_allreduce(comm, torch.zeros(4), op="max")
    with pytest.raises(ValueError, match="sum"):
        cuda_ring.ring_reduce_scatter(comm, torch.zeros(4), op="mean")
    with pytest.raises(ValueError, match="divisible"):
        cuda_ring.ring_reduce_scatter(comm, torch.zeros(5))


# ------------------------------------------------ per-rank CPU form, gloo world

def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    lifecycle.start(device="cpu")


def _job(kind, p, knobs, arrays, mean):
    """Rank r's result through the per-rank CPU form over ranks 0..p-1 of
    the world (every rank makes the group; ranks >= p sit out)."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.runtime.communicator import Communicator

    tconfig.reset(**knobs)
    comm = Communicator(range(p), my_rank=dist.get_rank())
    comm.group  # noqa: B018 - new_group is collective over the world
    me = dist.get_rank()
    if me >= p:
        return None
    x = _to_torch(arrays[me])
    if kind == "allreduce":
        out = cuda_ring.inner_ring_allreduce(x, p, mean=mean, comm=comm)
    elif kind == "reduce_scatter":
        out = cuda_ring.ring_reduce_scatter(comm, x)
    else:
        out = cuda_ring.ring_allgather(comm, x)
    return _bits(out), str(out.dtype), cuda_ring.ring_allreduce_launches


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(4, setup=_setup_cpu)
    yield pl
    pl.close()


GLOO_CASES = [
    ("allreduce", "float32", 2, 3000, "default", False),
    ("allreduce", "bfloat16", 4, 3000, "subchunks", True),
    ("allreduce", "int32", 4, 513, "one_slot", False),
    ("allreduce", "float32", 4, 5, "default", True),
    ("reduce_scatter", "bfloat16", 4, 3000, "subchunks", False),
    ("reduce_scatter", "float32", 2, 8, "one_slot", False),
    ("allgather", "float32", 4, 300, "one_slot", False),
    ("allgather", "bfloat16", 2, 5, "default", False),
]


@pytest.mark.parametrize("kind,dtype,p,n,knobs,mean", GLOO_CASES,
                         ids=["-".join(map(str, c)) for c in GLOO_CASES])
def test_gloo_form_equals_plain_bit_for_bit(pool, kind, dtype, p, n, knobs,
                                            mean):
    vals = _values(kind, dtype, p, n, seed=7 + p + n)
    res = pool.run(_job, kind, p, KNOBS[knobs], vals, mean)
    tconfig.reset(**KNOBS[knobs])
    try:
        xs = [_to_torch(v) for v in vals]
        want = (cuda_ring._ring_allreduce_plain(xs, mean=mean)
                if kind == "allreduce" else _plain(kind, xs))
    finally:
        tconfig.reset()
    for r in range(p):
        bits, dt, launches = res[r]
        assert dt == str(want[r].dtype)
        np.testing.assert_array_equal(bits, _bits(want[r]))
        assert launches == 0        # the CPU form launches no kernel
    assert all(x is None for x in res[p:])


# ------------------------------------------------------------------ the card

@pytest.fixture(scope="module")
def card_bench():
    """Every rank's results of the quick ring bench at p = 2 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ring kernels are CUDA only)")
    from torchmpi_tpu_torch.tools import ring_bench

    return ring_bench.run(2, quick=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter", "allgather"])
def test_kernel_equals_plain_on_the_card(card_bench, kind):
    for res in card_bench:
        recs = [r for r in res["records"] if r["kind"] == kind]
        assert recs and all(r["bitwise_equal"] for r in recs), recs
        assert res["collectives_ok"]


@pytest.mark.cuda
def test_stalled_ring_raises_on_the_card(card_bench):
    stall = card_bench[0]["stall"]
    assert stall["raised"] and stall["seconds"] < 5 * stall["deadline_s"]


@pytest.mark.cuda
def test_late_neighbour_cannot_lower_an_aborted_word_on_the_card(card_bench):
    """A rank that enters a ring after its neighbour gave up raises in turn,
    and its send leaves the neighbour's aborted data word where the abort
    put it, so no wait still queued behind the abort can hang."""
    from torchmpi_tpu_torch.tools import ring_bench

    late = card_bench[0]["late"]
    assert late["raised"] and late["kept_past_every_step"], late
    assert ring_bench.stalls_ok(card_bench[0]["stall"], late)


@pytest.mark.cuda
def test_resnet50_step_rings_equal_plain_on_the_card(card_bench):
    for res in card_bench:
        rings = res["resnet_rings"]
        assert rings["rings"] == 43 and rings["bitwise_equal"], rings


def test_resnet50_step_ring_sizes():
    """The engine's rings of one ResNet-50 step, as the bench drives them:
    42 leaves alone (65,536 to 2,359,296 elements), then the 309,288-element
    tail, 25,557,032 elements in all."""
    from torchmpi_tpu_torch.tools import ring_bench

    sizes = ring_bench.resnet50_ring_sizes("cpu")
    assert (len(sizes), sum(sizes)) == (43, 25_557_032)
    assert (max(sizes), sizes[-1]) == (2_359_296, 309_288)
    assert min(sizes[:-1]) == 65_536
