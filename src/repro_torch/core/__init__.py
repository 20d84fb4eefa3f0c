"""repro_torch.core -- MPI-style windows on storage (the paper's contribution).

This package's own copy of ``repro.core``.  Public API:
    Communicator                      rank bookkeeping + collectives over a
                                      pluggable transport
    Transport / InprocTransport /     the transport layer: in-process ranks
    RankLocalTransport /              (default), one externally launched
    MultiprocessTransport /           rank's own partition, or real worker
    TransportError / make_transport   processes (``REPRO_TRANSPORT=mp``)
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
    DistributedHashTable              paper §3.3 reference application
    MapReduce1S                       paper §3.5.2 reference application

The names that need ``torch`` (the window layer and what builds on it) are
imported lazily, on first use: an ``mp`` worker process imports this
package on its way to its entry point and must stay free of ``torch``.

Not ported yet (ROADMAP.md queue A): the tcp transport and SPMD launch,
resilience (replication, failover, rebuild) and the sanitizer.
"""

from .comm import Communicator
from .transport import (InprocTransport, RankLocalTransport, Transport,
                        TransportError, make_transport)
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

#: public names imported on first use, by module: these modules import torch
_LAZY = {
    "window": ("LOCK_EXCLUSIVE", "LOCK_SHARED", "Request", "Window",
               "WindowError", "alloc_mem"),
    "offload": ("WindowedArray", "WindowedPyTree", "auto_factor"),
    "dht": ("DistributedHashTable",),
    "mapreduce": ("MapReduce1S", "wordcount_map", "wordcount_reduce"),
    "transport": ("MultiprocessTransport",),
}
_LAZY_NAMES = {n: m for m, names in _LAZY.items() for n in names}


def __getattr__(name):
    mod = _LAZY_NAMES.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


__all__ = [
    "Communicator",
    "Transport",
    "TransportError",
    "InprocTransport",
    "RankLocalTransport",
    "MultiprocessTransport",
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
    "DistributedHashTable",
    "MapReduce1S",
    "wordcount_map",
    "wordcount_reduce",
]
