"""Parallelism strategies of the port: mesh construction over the ranks,
tensor parallel and sequence/context parallel (counterpart of
``torchmpi_tpu/parallel``; its ``blocks`` and ``pipeline`` wait for ROADMAP
item 14, ``moe`` for item 12a)."""

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
from . import sequence  # noqa: F401
from . import tp  # noqa: F401
