"""Typed transport faults of the host plane.

Counterpart of the typed errors of ``torchmpi_tpu/runtime/failure.py``:
the hostcomm rings raise these instead of bare ``RuntimeError`` s, so a
caller can tell a sick network (a deadline that expired, a damaged frame,
a reset connection) from a programming error.  A fault poisons the ring it
happened on; recovery is a fresh ring.
"""

from __future__ import annotations


class TransportFailure(RuntimeError):
    """A host-plane transport fault (timeout, corruption, reset).  Base of
    the typed errors below."""


class HostcommError(TransportFailure):
    """hostcomm ring I/O failure: a peer closed or reset its connection
    mid-operation, or the ring could not be wired."""


class HostcommTimeout(HostcommError):
    """A ring wait went past ``hc_io_deadline_ms`` with no progress.  The
    message carries the native side's rank, operation and bytes moved.
    With the knob at 0 this never fires: the ring warns and waits."""


class HostcommCorruption(HostcommError):
    """A received hostcomm frame failed its CRC32 trailer check
    (``hc_frame_crc``): the payload was damaged in flight and was not
    applied."""
