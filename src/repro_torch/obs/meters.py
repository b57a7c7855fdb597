"""Counters, gauges, and histograms — the numeric half of observability.

A process-global registry of named meters, stdlib-only and thread-safe,
plus the three samplers the analysis stack actually needs:

* :func:`rss_mb` / :func:`peak_rss_mb` — current and high-water process
  resident set (``/proc/self/statm`` where available, ``getrusage``
  everywhere; macOS's bytes-vs-KiB ``ru_maxrss`` quirk handled here once);
* :func:`device_memory_mb` — CUDA caching-allocator stats per visible
  card (``torch.cuda.memory_stats``); without a card the caller gets
  ``None``, never an exception;
* :func:`record_h2d` — the host->device transfer-byte tap every upload
  seam calls (`analysis.distributed` panel/adjacency uploads,
  `routing.throughput`'s per-round length uploads, the sweep's stacked
  upload). Counts into the ``h2d_bytes`` counter, accumulates into the
  innermost live span's ``h2d_bytes`` attribute, and emits a Perfetto
  counter sample — all gated on tracing being enabled so the hot paths
  stay untouched otherwise.

:func:`snapshot` returns the whole registry as one dict; `trace.export`
embeds it in the trace file's ``otherData``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from . import trace

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "snapshot", "reset", "rss_mb", "peak_rss_mb", "device_memory_mb",
           "sample_process", "record_h2d"]


class Counter:
    """Monotonic accumulator (bytes moved, rounds run, tiles pumped)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, delta=1) -> "Counter":
        with self._lock:
            self.value += delta
        return self

    def describe(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-value meter with a high-water mark (RSS, device memory)."""

    __slots__ = ("name", "value", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def set(self, value) -> "Gauge":
        with self._lock:
            self.value = value
            if value > self.max:
                self.max = value
        return self

    def describe(self) -> Dict:
        return {"type": "gauge", "value": self.value, "max": self.max}


class Histogram:
    """Streaming count/sum/min/max/mean (stage latencies, tile levels)."""

    __slots__ = ("name", "count", "total", "min", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._lock = threading.Lock()

    def observe(self, value) -> "Histogram":
        v = float(value)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
        return self

    def describe(self) -> Dict:
        if not self.count:
            return {"type": "histogram", "count": 0}
        return {"type": "histogram", "count": self.count,
                "sum": self.total, "min": self.min, "max": self.max,
                "mean": self.total / self.count}


_REGISTRY: Dict[str, object] = {}
_REG_LOCK = threading.Lock()


def _get(name: str, cls):
    m = _REGISTRY.get(name)
    if m is None:
        with _REG_LOCK:
            m = _REGISTRY.setdefault(name, cls(name))
    if not isinstance(m, cls):
        raise TypeError(f"meter {name!r} already registered as "
                        f"{type(m).__name__}")
    return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get(name, Histogram)


def snapshot() -> Dict[str, Dict]:
    with _REG_LOCK:
        items = list(_REGISTRY.items())
    return {name: m.describe() for name, m in sorted(items)}


def reset() -> None:
    with _REG_LOCK:
        _REGISTRY.clear()


# -- samplers ------------------------------------------------------------------

def rss_mb() -> float:
    """Current resident set in MB (0.0 where the platform hides it)."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        import os

        return pages * os.sysconf("SC_PAGE_SIZE") / 2**20
    except (OSError, ValueError, IndexError):
        return peak_rss_mb()


def peak_rss_mb() -> float:
    """High-water resident set in MB (ru_maxrss: bytes on macOS, KiB else)."""
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss / 2**20 if sys.platform == "darwin" else rss / 1024.0
    except (ImportError, OSError):
        return 0.0


def device_memory_mb() -> Optional[Dict[str, float]]:
    """Per-card allocator stats in MB (bytes in use), or None without a
    card. Never raises — observability must not take the analysis down."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        out = {}
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if "allocated_bytes.all.current" in stats:
                out[f"cuda:{i}"] = round(
                    stats["allocated_bytes.all.current"] / 2**20, 2)
        return out or None
    except Exception:  # noqa: BLE001 - absent backend APIs are expected
        return None


def sample_process(prefix: str = "process") -> Dict[str, float]:
    """Record RSS (and device memory when available) into gauges and, when
    tracing, a Perfetto counter track. Returns what it sampled."""
    sampled = {"rss_mb": round(rss_mb(), 1),
               "peak_rss_mb": round(peak_rss_mb(), 1)}
    gauge(f"{prefix}.rss_mb").set(sampled["rss_mb"])
    gauge(f"{prefix}.peak_rss_mb").set(sampled["peak_rss_mb"])
    dev = device_memory_mb()
    if dev:
        total = round(sum(dev.values()), 2)
        sampled["device_mb"] = total
        gauge(f"{prefix}.device_mb").set(total)
    trace.counter_sample(prefix, **sampled)
    return sampled


def record_h2d(nbytes: int, what: str = "") -> None:
    """Tap one host->device upload of ``nbytes``. Gated on tracing so the
    upload seams cost a single boolean check when observability is off."""
    if not trace.enabled():
        return
    counter("h2d_bytes").add(int(nbytes))
    if what:
        counter(f"h2d_bytes.{what}").add(int(nbytes))
    trace.current().inc("h2d_bytes", int(nbytes))
    trace.counter_sample("h2d_bytes", total=counter("h2d_bytes").value)
