"""The cases of ``tests/test_torch_hierarchical.py`` at p = 3: the uneven
2+1 split (keys r // 2), in a spawned pool of 3 gloo ranks of its own, each
rank's result held against row r of the JAX package's on the first 3
devices of the CPU mesh (integer-valued f32 bit for bit, random f32 within
1e-6 of the inputs' largest magnitude, JAX's refusals with the same
message)."""

from __future__ import annotations

import pytest

import test_torch_hierarchical as hier

PARAMS = [(case, kind) for case in hier.CASES
          for kind in (("int", "rand") if hier.CASES[case][0] else ("int",))]


@pytest.fixture(scope="module")
def pool():
    pl = hier.make_pool(3)
    yield pl
    pl.close()


@pytest.mark.parametrize("case,kind", PARAMS,
                         ids=[f"2+1-{c}-{k}" for c, k in PARAMS])
def test_case_rows_equal_jax_at_p3(pool, case, kind):
    hier.check_case(pool, "2+1", case, kind)
