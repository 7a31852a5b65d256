"""Runtime of the port: the knob registry (``config``), communicators, the
process lifecycle, handles, failure detection and elastic recovery
(``failure``), transport chaos (``chaos``); ``resize`` and ``election``
load on first import."""

from . import chaos  # noqa: F401
from . import communicator, config, lifecycle  # noqa: F401
from .failure import (  # noqa: F401
    FaultInjector,
    HeartbeatMonitor,
    HostcommCorruption,
    HostcommError,
    HostcommTimeout,
    InjectedFault,
    PSTransportError,
    TransportFailure,
    is_device_failure,
    run_elastic,
)
from .communicator import (  # noqa: F401
    Communicator,
    CommunicatorGuard,
    CommunicatorStack,
    CommunicatorType,
    stack,
)
from .handles import (  # noqa: F401
    ParameterServerSynchronizationHandle,
    SynchronizationHandle,
    sync_all,
    wait,
    wait_all,
)
from .lifecycle import (  # noqa: F401
    barrier,
    communicator_names,
    hostname,
    need_inter_node_collectives,
    process_count,
    process_rank,
    rank,
    size,
    start,
    started,
    stop,
)
