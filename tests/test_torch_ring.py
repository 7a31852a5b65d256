"""The port's ring collectives (``collectives/cuda_ring.py``) against the JAX
package's ``pallas_ring``.

* ``_geometry`` equals JAX's over a grid of sizes, rank counts, item sizes
  and buffer knobs.
* The plain schedule (``_ring_*_plain``, all ranks in one process) equals
  ``pallas_ring.ring_allreduce`` / ``ring_reduce_scatter`` /
  ``ring_allgather`` run in interpret mode on p of the 8 virtual CPU devices
  **bit for bit**, in f32, bf16 (random values) and int32, with sub-chunks
  and with one staging slot: the same chunks summed in the same order in
  the wire dtype leave no room for any difference, so the test asks for
  exact equality, not a tolerance.
* The one-shot plain versions (``_oneshot_*_plain``: each element summed
  over the ranks in its ring chunk's order, the oracle of the one-shot B1
  and B2 kernels; every rank's vector in rank order, the oracle of B3's)
  equal the plain schedule and the JAX package's interpret-mode kernels
  bit for bit, over p = 2, 3, 4, f32, bf16 and int32, mean on and off,
  n = 5, 3,000 and a lane-aligned size, and the 64 KiB
  ``max_buffer_size`` knob (which moves the chunk boundaries).
* The per-rank CPU form (send/recv of chunks over a gloo world, one pool of
  4 spawned ranks for the module) equals the plain schedule, also exactly.
* On a GPU (``cuda`` marker) the kernels equal their one-shot plain
  versions exactly, at p = 2 and p = 4.
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


# ------------------------------------------------ the one-shot plain versions

KNOBS["64k"] = {"max_buffer_size": 1 << 16, "min_buffer_size": 1 << 12}
# 128 x 548: lane-aligned, and with the 64 KiB knob f32 chunks of 274, 183
# and 137 rows (p = 2, 3, 4) grow to 276, 184 and 138.
LANE_N = 70_144
ONESHOT_SIZES = (5, 3000, LANE_N)


def _oneshot(kind: str, xs, mean: bool = False):
    if kind == "allreduce":
        return cuda_ring._oneshot_allreduce_plain(xs, mean=mean)
    if kind == "allgather":
        return cuda_ring._oneshot_allgather_plain(xs)
    return cuda_ring._oneshot_reduce_scatter_plain(xs)


def _ring(kind: str, xs, mean: bool = False):
    if kind == "allreduce":
        return cuda_ring._ring_allreduce_plain(xs, mean=mean)
    if kind == "allgather":
        return cuda_ring._ring_allgather_plain(xs)
    return cuda_ring._ring_reduce_scatter_plain(xs)


def _size(kind: str, n: int, p: int) -> int:
    """n, cut to a multiple of p for the reduce-scatter."""
    return n - n % p if kind == "reduce_scatter" else n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter", "allgather"])
def test_oneshot_plain_equals_ring_plain_bit_for_bit(kind, p, dtype):
    try:
        for knobs in ("default", "64k"):
            tconfig.reset(**KNOBS[knobs])
            for n in ONESHOT_SIZES:
                m = _size(kind, n, p)
                xs = [_to_torch(v) for v in
                      _values(kind, dtype, p, m, seed=n + p)]
                for mean in ((False, True) if kind == "allreduce"
                             else (False,)):
                    got, want = _oneshot(kind, xs, mean), _ring(kind, xs, mean)
                    for r in range(p):
                        assert got[r].dtype == want[r].dtype
                        np.testing.assert_array_equal(
                            _bits(got[r]), _bits(want[r]),
                            err_msg=f"{knobs} n={m} mean={mean} rank {r}")
    finally:
        tconfig.reset()


# (kind, dtype, p, n, knobs, mean): every p, dtype, size, knob and mean at
# least once against the JAX package's interpret-mode kernels.
ONESHOT_JAX_CASES = [
    ("allreduce", "float32", 2, 5, "default", False),
    ("allreduce", "bfloat16", 3, 3000, "64k", True),
    ("allreduce", "int32", 4, LANE_N, "64k", False),
    ("allreduce", "float32", 3, LANE_N, "64k", True),
    ("allreduce", "bfloat16", 4, 5, "default", False),
    ("allreduce", "int32", 2, 3000, "default", True),
    ("reduce_scatter", "float32", 4, 3000, "64k", False),
    ("reduce_scatter", "bfloat16", 3, LANE_N - 1, "default", False),
    ("reduce_scatter", "int32", 2, 4, "default", False),
    ("allgather", "float32", 2, 5, "default", False),
    ("allgather", "bfloat16", 2, LANE_N, "64k", False),
    ("allgather", "float32", 3, 3000, "64k", False),
    ("allgather", "bfloat16", 3, 5, "default", False),
    ("allgather", "float32", 4, LANE_N, "default", False),
    ("allgather", "bfloat16", 4, 3000, "64k", False),
]


@pytest.mark.parametrize("kind,dtype,p,n,knobs,mean", ONESHOT_JAX_CASES,
                         ids=["-".join(map(str, c))
                              for c in ONESHOT_JAX_CASES])
def test_oneshot_plain_equals_jax_interpret_bit_for_bit(
        both_configs, kind, dtype, p, n, knobs, mean):
    import jax

    from torchmpi_tpu.collectives import eager, pallas_ring
    from torchmpi_tpu.runtime.communicator import Communicator

    _set(both_configs, KNOBS[knobs])
    pallas_ring.clear_cache()
    assert pallas_ring.RING_KERNELS_AVAILABLE
    vals = _values(kind, dtype, p, n, seed=50 + ONESHOT_JAX_CASES.index(
        (kind, dtype, p, n, knobs, mean)))
    comm = Communicator(jax.devices()[:p])
    x = eager.shard(comm, vals)
    if kind == "allreduce":
        ref = pallas_ring.ring_allreduce(comm, x,
                                         op="mean" if mean else "sum")
    elif kind == "allgather":
        ref = pallas_ring.ring_allgather(comm, x)
    else:
        ref = pallas_ring.ring_reduce_scatter(comm, x)
    ref = np.asarray(jax.device_get(ref))
    got = _oneshot(kind, [_to_torch(v) for v in vals], mean)
    for r in range(p):
        assert _bits(got[r]).dtype == _bits(ref[r]).dtype
        np.testing.assert_array_equal(_bits(got[r]), _bits(ref[r]))
    pallas_ring.clear_cache()


def test_oneshot_chunk_map_uses_the_padded_rows():
    """Element i lies in chunk i // (rows * 128) of the ring's padded
    layout, not i // (n / p).  At p = 3 the ranks hold 1, 2^24, 1 in f32:
    chunk 0 sums from rank 1 (2^24 + 1 rounds to 2^24, then + 1 again),
    chunk 1 from rank 2 (1 + 1 + 2^24 = 2^24 + 2, exact), chunk 2 from rank
    0 (as chunk 0).  n = 70,000: per-rank 23,334 elements, 183 rows of 128
    by default, 184 under the 64 KiB knob (two sub-chunks of 92 rows)."""
    big = float(1 << 24)
    xs = [torch.full((70_000,), v) for v in (1.0, big, 1.0)]
    try:
        for knobs, rows in (("default", 183), ("64k", 184)):
            tconfig.reset(**KNOBS[knobs])
            assert cuda_ring._geometry(70_000, 3, 4)[0] == rows
            c = rows * 128
            want = torch.full((70_000,), big)
            want[c:2 * c] = big + 2
            out = cuda_ring._oneshot_allreduce_plain(xs)[0]
            assert torch.equal(out, want), knobs
            assert torch.equal(out, cuda_ring._ring_allreduce_plain(xs)[0])
    finally:
        tconfig.reset()


def test_oneshot_plain_takes_offset_views():
    """Inputs that start inside their storage (as a public caller's slices
    may) give the same bits as fresh tensors."""
    for kind, dtype, p, n in (("allreduce", "bfloat16", 3, 3000),
                              ("reduce_scatter", "float32", 4, 3000)):
        vals = _values(kind, dtype, p, n, seed=11)
        fresh = [_to_torch(v) for v in vals]
        views = [torch.cat([t[:3], t])[3:] for t in fresh]
        assert all(v.storage_offset() == 3 for v in views)
        for a, b, c in zip(_oneshot(kind, views), _oneshot(kind, fresh),
                           _ring(kind, fresh)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
            np.testing.assert_array_equal(_bits(a), _bits(c))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_oneshot_allgather_plain_takes_offset_views(dtype):
    """B3's oracle on inputs that start inside their storage, at an n that
    is no multiple of 16 bytes' lanes (so GATHER's rows past the first
    start unaligned): every rank's vector in rank order, equal to the
    ring's steps over fresh tensors."""
    vals = _values("allgather", dtype, 3, 3001, seed=13)
    fresh = [_to_torch(v) for v in vals]
    views = [torch.cat([t[:1], t])[1:] for t in fresh]
    assert all(v.storage_offset() == 1 for v in views)
    got = cuda_ring._oneshot_allgather_plain(views)
    for a, b in zip(got, _ring("allgather", fresh)):
        assert a.shape == (3 * 3001,)
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(got[0]), _bits(np.concatenate(vals)))


def test_bf16_running_sum_rounds_after_every_add():
    """The wire-dtype rule and the chunk order, visibly.  Ranks hold 1, 256,
    1, 1 (bf16 spacing is 2 above 256); 256 elements at p = 4 make two
    chunks of 128 and two of padding.  Chunk 0 sums from rank 1: 256 + 1
    rounds to 256, and stays there; chunk 1 sums from rank 2: 1 + 1 + 1 +
    256 = 259, which rounds to 260.  An f32 sum would give 259 everywhere.
    The ring's steps and the one-shot order agree."""
    xs = [torch.tensor([v] * 256, dtype=torch.bfloat16)
          for v in (1.0, 256.0, 1.0, 1.0)]
    for out in (cuda_ring._ring_allreduce_plain(xs)
                + cuda_ring._oneshot_allreduce_plain(xs)):
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
    ("allgather", "int32", 3, 3000, "default", False),
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


def _offset_job(kind, p, arrays, mean):
    """Rank r's result through the per-rank CPU form for an input that
    starts 3 elements into its storage."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.runtime.communicator import Communicator

    tconfig.reset()
    comm = Communicator(range(p), my_rank=dist.get_rank())
    comm.group  # noqa: B018 - new_group is collective over the world
    me = dist.get_rank()
    if me >= p:
        return None
    t = _to_torch(arrays[me])
    x = torch.cat([t[:3], t])[3:]
    assert x.storage_offset() == 3
    if kind == "allreduce":
        out = cuda_ring.ring_allreduce(comm, x, op="mean" if mean else "sum")
    elif kind == "allgather":
        out = cuda_ring.ring_allgather(comm, x)
    else:
        out = cuda_ring.ring_reduce_scatter(comm, x)
    return _bits(out)


@pytest.mark.parametrize("kind,dtype,p,mean", [
    ("allreduce", "bfloat16", 3, True), ("reduce_scatter", "float32", 4,
                                         False),
    ("allgather", "int32", 3, False)])
def test_gloo_form_takes_an_offset_view(pool, kind, dtype, p, mean):
    vals = _values(kind, dtype, p, 3000, seed=23 + p)
    res = pool.run(_offset_job, kind, p, vals, mean)
    want = _oneshot(kind, [_to_torch(v) for v in vals], mean)
    for r in range(p):
        np.testing.assert_array_equal(res[r], _bits(want[r]))


def test_breakdown_splits_device_ops_by_call():
    """``ring_bench.split_calls``: each device operation goes to the call
    whose host range holds its start; busy time is the union of the
    operations' intervals, the gaps the rest of their span."""
    from torchmpi_tpu_torch.tools import ring_bench

    calls = ring_bench.split_calls(
        [(0.0, 10.0), (10.0, 30.0), (30.0, 40.0)],
        [("stage", 1.0, 3.0), ("reduce", 7.0, 8.0), ("copy", 2.0, 5.0),
         ("stage", 12.0, 20.0)])
    assert calls[0] == {"ops": 3, "names": {"stage": 1, "copy": 1,
                                            "reduce": 1},
                        "busy_us": 5.0, "gap_us": 2.0, "lead_us": 1.0}
    assert calls[1]["ops"] == 1 and calls[1]["busy_us"] == 8.0
    assert calls[1]["gap_us"] == 0.0 and calls[1]["lead_us"] == 2.0
    assert calls[2] == {"ops": 0, "names": {}, "busy_us": 0.0, "gap_us": 0.0,
                        "lead_us": None}


def test_breakdown_joins_the_ranks_traces():
    """``ring_bench.across_ranks``: two ranks' traces of two one-shot calls
    on one clock; per call the window over both ranks, the time some
    rank's operation ran, the skew of their starts, the handoff from the
    last STAGE to the first REDUCE and the tail to the last return."""
    from torchmpi_tpu_torch.tools import ring_bench

    r0 = ([(0.0, 100.0), (100.0, 200.0)],
          [("stage_kernel<float>", 10.0, 12.0),
           ("reduce_kernel<float>", 50.0, 52.0),
           ("stage_kernel<float>", 110.0, 112.0),
           ("reduce_kernel<float>", 160.0, 162.0)])
    r1 = ([(5.0, 110.0), (105.0, 200.0)],
          [("stage_kernel<float>", 20.0, 22.0),
           ("reduce_kernel<float>", 30.0, 32.0),
           ("stage_kernel<float>", 120.0, 121.0),
           ("reduce_kernel<float>", 130.0, 131.0)])
    first, second = ring_bench.across_ranks([r0, r1])
    assert first == {"window_us": 110.0, "busy_any_us": 8.0,
                     "idle_us": 102.0, "skew_us": 5.0, "handoff_us": 8.0,
                     "tail_us": 58.0}
    assert second["handoff_us"] == 9.0 and second["tail_us"] == 38.0
    # A trace without a STAGE and a consumer a rank (an older tree's ring
    # steps and copies): no handoff.
    steps = ([(0.0, 10.0)], [("Memcpy DtoD", 1.0, 2.0)])
    assert "handoff_us" not in ring_bench.across_ranks([steps, steps])[0]


def test_breakdown_hands_off_from_stage_to_gather():
    """``ring_bench.across_ranks`` on B3's one-shot calls: the handoff runs
    from the last STAGE to the first GATHER, the tail from the last GATHER
    to the last rank's return."""
    from torchmpi_tpu_torch.tools import ring_bench

    r0 = ([(0.0, 100.0)], [("stage_kernel<float, true>", 10.0, 20.0),
                           ("gather_kernel<unsigned int, true>", 60.0, 70.0)])
    r1 = ([(2.0, 90.0)], [("stage_kernel<float, true>", 30.0, 40.0),
                          ("gather_kernel<unsigned int, true>", 45.0, 55.0)])
    (call,) = ring_bench.across_ranks([r0, r1])
    assert call == {"window_us": 100.0, "busy_any_us": 40.0,
                    "idle_us": 60.0, "skew_us": 2.0, "handoff_us": 5.0,
                    "tail_us": 30.0}


# ------------------------------------------------------------------ the card

@pytest.fixture(scope="module")
def card_bench():
    """Every rank's results of the quick ring bench at p = 2 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ring kernels are CUDA only)")
    from torchmpi_tpu_torch.tools import ring_bench

    return ring_bench.run(2, quick=True)


@pytest.fixture(scope="module")
def card_bench_p4():
    """Every rank's results of the quick ring bench at p = 4 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ring kernels are CUDA only)")
    from torchmpi_tpu_torch.tools import ring_bench

    return ring_bench.run(4, quick=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter", "allgather"])
def test_kernel_equals_plain_on_the_card(card_bench, kind):
    """B1, B2 and B3 against their one-shot plain versions, at p = 2."""
    for res in card_bench:
        recs = [r for r in res["records"] if r["kind"] == kind]
        assert recs and all(r["bitwise_equal"] for r in recs), recs
        assert res["collectives_ok"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["allreduce", "reduce_scatter", "allgather"])
def test_kernel_equals_plain_at_p4_on_the_card(card_bench_p4, kind):
    for res in card_bench_p4:
        recs = [r for r in res["records"] if r["kind"] == kind]
        assert recs and all(r["bitwise_equal"] for r in recs), recs
        assert res["collectives_ok"]
        assert res["resnet_rings"]["bitwise_equal"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["allreduce", "allgather"])
def test_back_to_back_calls_reuse_both_slots_on_the_card(card_bench,
                                                         card_bench_p4, kind):
    """Three calls on one id (slot 0, slot 1, slot 0 again; the second
    input an offset view, for the allreduce the second call a mean), each
    equal to its plain version on every rank, at p = 2 and p = 4."""
    for res in card_bench + card_bench_p4:
        calls = res["back_to_back"][kind]
        assert [c["call"] for c in calls] == [0, 1, 2]
        assert calls[1]["offset_view"]
        assert calls[1]["mean"] == (kind == "allreduce")
        assert all(c["bitwise_equal"] for c in calls), calls


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["allreduce", "allgather"])
def test_stalled_ring_raises_on_the_card(card_bench, kind):
    stall = card_bench[0]["stalls"][kind]["stall"]
    assert stall["raised"] and stall["seconds"] < 5 * stall["deadline_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["allreduce", "allgather"])
def test_late_neighbour_cannot_lower_an_aborted_word_on_the_card(card_bench,
                                                                 kind):
    """A rank that enters a ring after its neighbour gave up raises in turn,
    and its STAGE's add leaves the neighbour's aborted READY word where the
    abort put it, so no wait still queued behind the abort can hang."""
    from torchmpi_tpu_torch.tools import ring_bench

    stalls = card_bench[0]["stalls"]
    late = stalls[kind]["late"]
    assert late["raised"] and late["kept_past_every_step"], late
    assert ring_bench.stalls_ok({kind: stalls[kind]})


@pytest.mark.cuda
def test_fresh_ring_state_is_zeroed_before_a_neighbour_sends(card_bench):
    """The first call on a new collective id, made while rank 0's stream is
    busy, equals the plain schedule: the staging is zeroed before its
    handle is shared, not behind the rank's pending work."""
    for res in card_bench:
        assert res["fresh_state"]["bitwise_equal"], res["fresh_state"]


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


@pytest.mark.cuda
def test_resnet50_async_bucket_rings_equal_plain_on_the_card(card_bench):
    for res in card_bench:
        rings = res["bucket_rings"]
        assert rings["rings"] == 4 and rings["bitwise_equal"], rings


def test_resnet50_async_bucket_sizes():
    """The buckets of one ResNet-50 eager_async step, in dispatch order (the
    ready order: last layers first), as the bench drives them: every
    parameter once, every bucket above the small-message cutoff."""
    from torchmpi_tpu_torch.runtime import config
    from torchmpi_tpu_torch.tools import ring_bench

    sizes = ring_bench.resnet50_bucket_sizes("cpu")
    assert sizes == [2_057_536, 7_871_464, 7_356_416, 8_271_616]
    assert sum(sizes) == 25_557_032
    assert min(sizes) > int(config.get("small_allreduce_size_gpu"))
