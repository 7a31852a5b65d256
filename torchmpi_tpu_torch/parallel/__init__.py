"""Parallelism strategies of the port: mesh construction over the ranks,
tensor parallel, block/pipeline model parallel, sequence/context parallel
and expert parallel (counterpart of ``torchmpi_tpu/parallel``)."""

from .mesh import (  # noqa: F401
    AXIS_DP,
    AXIS_EP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    data_parallel_mesh,
    make_mesh,
    mesh_axis_size,
    validate_hosts_on_slow_axes,
)
from .blocks import BlockSequential, partition_contiguous  # noqa: F401
from .pipeline import (  # noqa: F401
    make_1f1b_step,
    make_pipeline_fn,
    microbatch,
    pipeline_stats,
    schedule_1f1b,
    stack_stage_params,
    stage_sharding,
    unmicrobatch,
)
from . import moe  # noqa: F401
from . import sequence  # noqa: F401
from . import tp  # noqa: F401
