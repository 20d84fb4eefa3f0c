"""repro_torch.core -- MPI-style windows on storage (the paper's contribution).

This package's own copy of ``repro.core``, trimmed to the single-process
path.  Public API:
    Communicator                      rank bookkeeping + collectives over a
                                      pluggable transport
    Transport / InprocTransport /     the transport layer (in-process ranks;
    TransportError / make_transport   the other backends are later slices)
    Window / alloc_mem                MPI_Win_* analogues (allocate, put/get,
                                      accumulate, CAS, lock/unlock, sync, free)
                                      and the device-side selective sync over
                                      torch tensors
    Request / WritebackPool           nonblocking layer: rput/rget/raccumulate
                                      handles + the background flush pipeline
    WindowHints / Info / HintError    the paper's MPI_Info performance hints
    CombinedSegment                   heterogeneous memory+storage allocation
    DirtyTracker / backings           user-level page cache + selective sync
    WindowedArray / WindowedPyTree    out-of-core arrays and trees

Not ported yet (ROADMAP.md queue A): the mp/tcp/spmd/ranklocal transports,
the codec, resilience (replication, failover, rebuild), the sanitizer, DHT
and MapReduce.
"""

from .comm import Communicator
from .transport import (InprocTransport, Transport, TransportError,
                        make_transport)
from .hints import HintError, Info, WindowHints
from .storage import (
    DEFAULT_PAGE_SIZE,
    CachedBacking,
    DirtyTracker,
    MmapBacking,
    StripedFile,
    WritebackPool,
    make_backing,
)
from .combined import CombinedSegment
from .window import (LOCK_EXCLUSIVE, LOCK_SHARED, Request, Window,
                     WindowError, alloc_mem)
from .offload import WindowedArray, WindowedPyTree, auto_factor

__all__ = [
    "Communicator",
    "Transport",
    "TransportError",
    "InprocTransport",
    "make_transport",
    "HintError",
    "Info",
    "WindowHints",
    "DEFAULT_PAGE_SIZE",
    "CachedBacking",
    "DirtyTracker",
    "MmapBacking",
    "StripedFile",
    "WritebackPool",
    "make_backing",
    "CombinedSegment",
    "LOCK_EXCLUSIVE",
    "LOCK_SHARED",
    "Request",
    "Window",
    "WindowError",
    "alloc_mem",
    "WindowedArray",
    "WindowedPyTree",
    "auto_factor",
]
