"""Resource gauges and timing helpers of the port's telemetry.

``live_device_bytes`` is the port's counterpart of the JAX package's sum
over ``jax.live_arrays()``: PyTorch keeps no registry of live tensors,
so the gauge reads the CUDA caching allocator's counters on a card and
walks the garbage collector's objects on the CPU.  It takes the device
explicitly; the telemetry passes the engine's ``RunConfig.device``.

``host_rss_bytes`` and ``steady_mean`` are the JAX package's own
definitions (stdlib only; host RSS from ``/proc/self/status``, falling
back to ``resource.getrusage``).
"""
from __future__ import annotations

import gc
from typing import Optional, Sequence

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


class PeakLiveBytes:
    """Track the peak of ``live_device_bytes(device)`` across a run.

    ``sample`` matches the engine's per-round callback signature
    (``callback(gen, report)``), so an instance can be passed straight as
    ``FedEngine.run(callback=peak.sample)``; it also works with no
    arguments for manual probing.  ``baseline`` is sampled at
    construction; ``peak`` is the largest sample since then (the
    baseline included), and ``growth`` the peak over the baseline, so
    tensors held by earlier work never bias a later measurement.  Only
    the moments sampled count: on a card, ``torch.cuda.max_memory_allocated``
    is the allocator's own high-water mark between samples."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.baseline = live_device_bytes(self.device)
        self.peak = self.baseline

    def sample(self, *_args) -> int:
        self.peak = max(self.peak, live_device_bytes(self.device))
        return self.peak

    @property
    def growth(self) -> int:
        return self.peak - self.baseline


def steady_mean(values: Sequence[float]) -> Optional[float]:
    """Steady-state mean: drop the first element (it pays first-call
    set-up) and average the rest; with a single element return it as-is;
    empty input returns None."""
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return float(sum(values[1:]) / (len(values) - 1))
