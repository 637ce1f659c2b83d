"""Memory accounting: ``photon_mem_*`` gauges for host RSS and device memory.

The JAX package's ``obs/memory.py`` on the port. The host half is the same
(``/proc/self/status``); the device half reads PyTorch's caching allocator
(``torch.cuda.memory_stats``, ``max_memory_allocated`` and the card's total
memory) in place of JAX's ``Device.memory_stats``. Devices are passed in by
the caller; a CPU device has no allocator statistics and is skipped.

Gauge families::

    photon_mem_host_rss_bytes            VmRSS at the last sample
    photon_mem_host_peak_rss_bytes       VmHWM (kernel-tracked high water)
    photon_mem_device_bytes_in_use{device=}       allocator bytes in use
    photon_mem_device_peak_bytes_in_use{device=}  max over samples (or the
                                                  allocator's own peak)
    photon_mem_device_bytes_limit{device=}        the card's total memory
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

_PROC_STATUS = "/proc/self/status"


def read_host_memory(proc_status: str = _PROC_STATUS) -> Dict[str, int]:
    """Host memory from ``/proc/self/status``: ``rss_bytes`` (VmRSS) and
    ``peak_rss_bytes`` (VmHWM, the kernel's own high-water mark, so a spike
    between samples is still captured). Falls back to ``resource.getrusage``
    (peak only) off Linux; returns {} when neither source exists."""
    out: Dict[str, int] = {}
    try:
        with open(proc_status) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss_bytes"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["peak_rss_bytes"] = int(line.split()[1]) * 1024
    except OSError:
        pass
    if "peak_rss_bytes" not in out:
        try:
            import resource

            out["peak_rss_bytes"] = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
        except Exception:  # no resource module: no peak
            pass
    return out


def read_device_memory(device) -> Optional[Dict[str, int]]:
    """The caching allocator's ``bytes_in_use``, ``peak_bytes_in_use`` and
    the card's ``bytes_limit`` for a CUDA ``device``; None for any other."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }


def _set_peak(family, value: float, **labels) -> None:
    """Monotone gauge: keep the max of the current and the new value."""
    child = family.labels(**labels)
    if value > child.value:
        child.set(value)


def sample_memory(registry, devices: Optional[Iterable] = None) -> Dict[str, int]:
    """Record one memory sample into ``registry``'s ``photon_mem_*`` gauges.

    Cheap host-only work (a /proc read and the allocator's counters), so
    instrumentation sites call it unconditionally. Returns the host
    reading."""
    host = read_host_memory()
    if "rss_bytes" in host:
        registry.gauge(
            "photon_mem_host_rss_bytes", "host resident set size at last sample"
        ).set(host["rss_bytes"])
    if "peak_rss_bytes" in host:
        _set_peak(
            registry.gauge(
                "photon_mem_host_peak_rss_bytes",
                "host resident set size high-water mark (VmHWM)",
            ),
            host["peak_rss_bytes"],
        )
    for dev in devices or ():
        stats = read_device_memory(dev)
        if not stats:
            continue
        label = str(dev)
        registry.gauge(
            "photon_mem_device_bytes_in_use",
            "device allocator bytes in use at last sample",
        ).labels(device=label).set(float(stats["bytes_in_use"]))
        _set_peak(
            registry.gauge(
                "photon_mem_device_peak_bytes_in_use",
                "device allocator bytes-in-use high-water mark",
            ),
            float(stats["peak_bytes_in_use"]),
            device=label,
        )
        registry.gauge(
            "photon_mem_device_bytes_limit", "device allocator capacity"
        ).labels(device=label).set(float(stats["bytes_limit"]))
    return host


def memory_block(snapshot: List[dict]) -> dict:
    """The ``memory`` document for run_summary.json and /statusz, assembled
    from a registry snapshot's ``photon_mem_*`` (and, when a run streamed,
    ``photon_stream_budget*``) gauges. Empty dict when the run never
    sampled."""
    host: Dict[str, float] = {}
    devices: Dict[str, dict] = {}
    budget: Dict[str, dict] = {}
    for m in snapshot:
        name, value = m["name"], m.get("value")
        if value is None:
            continue
        if name == "photon_mem_host_rss_bytes":
            host["rss_bytes"] = int(value)
        elif name == "photon_mem_host_peak_rss_bytes":
            host["peak_rss_bytes"] = int(value)
        elif name.startswith("photon_mem_device_"):
            dev = str(m.get("labels", {}).get("device", ""))
            key = name[len("photon_mem_device_"):]
            devices.setdefault(dev, {})[key] = int(value)
        elif name == "photon_stream_budget_bytes":
            site = str(m.get("labels", {}).get("site", ""))
            budget.setdefault(site, {})["hbm_budget_bytes"] = int(value)
        elif name == "photon_stream_budget_headroom_bytes":
            site = str(m.get("labels", {}).get("site", ""))
            budget.setdefault(site, {})["hbm_budget_headroom_bytes"] = int(value)
    out: dict = {}
    if host:
        out["host"] = host
    if devices:
        out["devices"] = devices
    if budget:
        out["streaming"] = budget
    return out
