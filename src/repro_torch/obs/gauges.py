"""Resource gauges of the port's telemetry.

``live_device_bytes`` is the port's counterpart of the JAX package's sum
over ``jax.live_arrays()``: PyTorch keeps no registry of live tensors,
so the gauge reads the CUDA caching allocator's counters on a card and
walks the garbage collector's objects on the CPU.  It takes the device
explicitly; the telemetry passes the engine's ``RunConfig.device``.

``host_rss_bytes`` is the JAX package's own definition (stdlib only; host
RSS from ``/proc/self/status``, falling back to ``resource.getrusage``).
"""
from __future__ import annotations

import gc

import torch


def live_device_bytes(device) -> int:
    """Bytes of the tensors that live on ``device`` now.

    On a CUDA device: ``torch.cuda.memory_allocated(device)``, the
    caching allocator's count of the bytes its live blocks hold.  It
    reads counters on the host and waits on nothing.  On the CPU: the
    bytes of the distinct storages of the live tensors that the garbage
    collector tracks (a storage shared by several views counts once)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.memory_allocated(device))
    storages = {}
    for obj in gc.get_objects():
        # type(), not isinstance: a proxy's __class__ property could run
        # arbitrary code
        if not issubclass(type(obj), torch.Tensor) or obj.device != device:
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):   # no storage (sparse)
            continue
        storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def host_rss_bytes() -> int:
    """Current process resident-set size in bytes (0 if unknowable).

    Prefers ``/proc/self/status`` (current VmRSS); falls back to
    ``resource.getrusage`` ru_maxrss (a lifetime *peak*, kilobytes on
    Linux) where /proc is unavailable.
    """
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (ImportError, OSError):
        return 0
