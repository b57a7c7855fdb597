"""Hierarchical tracing — the observability layer's span substrate.

One process-global :class:`Tracer` records **spans** (named, nested,
attributed wall-time intervals) and exports them as Chrome trace-event
JSON, loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``
as-is. The design constraints, in order:

* **zero overhead off** — :func:`span` is the only call sites pay for, and
  with tracing disabled it returns one shared no-op singleton after a
  single attribute check. Nothing else runs: no timestamps, no locks, no
  allocation. The device engines read the flag once per call to decide
  whether to fold their telemetry into a span.
* **thread-safe** — span stacks are thread-local (each thread is its own
  Perfetto track via ``tid``); the completed-event list is append-only
  under one lock.
* **zero dependencies** — stdlib only; torch is never imported here.

Kill switch: :func:`enable` / :func:`disable`, or the ``REPRO_TRACE``
environment variable — ``1`` enables for the process, any other non-empty
value is treated as an output path that is auto-exported at exit.

Spans nest lexically::

    with obs.span("sweep", families=12) as sp:
        with obs.span("sweep.wavefront"):
            ...
        sp.set(levels=7)          # attach attributes after the fact
        sp.inc("h2d_bytes", n)    # accumulate into an attribute

:func:`instant` marks a point event (MWU round, autotune decision),
:func:`log` is the structured replacement for ad-hoc ``print`` reporting
(one readable line on stderr-free stdout AND an instant event in the
trace), and :func:`export` writes the Chrome JSON.
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "enabled", "enable", "disable", "reset", "span",
           "current", "traced", "instant", "counter_sample", "log",
           "export", "events", "span_summary", "ENV_FLAG"]

ENV_FLAG = "REPRO_TRACE"


def _json_safe(v):
    """Attribute values must survive json.dumps: numpy scalars unwrap,
    small arrays/sequences become lists, everything else goes str."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        return item()
    tolist = getattr(v, "tolist", None)
    if tolist is not None and getattr(v, "size", 1 << 30) <= 4096:
        return tolist()
    return str(v)


class _NullSpan:
    """The disabled-path singleton: every method is a no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def inc(self, key: str, delta):
        return self

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: created by :meth:`Tracer.span`, closed on __exit__."""

    __slots__ = ("tracer", "name", "cat", "args", "ts", "dur", "tid")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.ts = 0
        self.dur = 0
        self.tid = 0

    def set(self, **attrs) -> "_Span":
        self.args.update(attrs)
        return self

    def inc(self, key: str, delta) -> "_Span":
        self.args[key] = self.args.get(key, 0) + delta
        return self

    def __bool__(self):
        return True

    def __enter__(self) -> "_Span":
        t = self.tracer
        self.tid = threading.get_ident()
        t._stack().append(self)
        self.ts = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur = time.perf_counter_ns() - self.ts
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self.tracer._emit({
            "name": self.name, "cat": self.cat, "ph": "X",
            "ts": (self.ts - self.tracer.epoch_ns) / 1e3,
            "dur": self.dur / 1e3,
            "pid": self.tracer.pid, "tid": self.tid,
            "args": {k: _json_safe(v) for k, v in self.args.items()},
        })
        return False


class Tracer:
    """Span recorder + Chrome trace-event exporter (see module docstring)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.pid = os.getpid()
        self.epoch_ns = time.perf_counter_ns()
        self._events: List[Dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- internals ---------------------------------------------------------

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _emit(self, event: Dict) -> None:
        with self._lock:
            self._events.append(event)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, cat: str = "analysis", **args):
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def current(self):
        """The innermost live span on this thread (NULL_SPAN when none or
        disabled) — lets deep code annotate its caller's span."""
        if not self.enabled:
            return NULL_SPAN
        stack = self._stack()
        return stack[-1] if stack else NULL_SPAN

    def instant(self, name: str, cat: str = "analysis", **args) -> None:
        """A point event (Perfetto renders these as markers)."""
        if not self.enabled:
            return
        self._emit({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": (time.perf_counter_ns() - self.epoch_ns) / 1e3,
            "pid": self.pid, "tid": threading.get_ident(),
            "args": {k: _json_safe(v) for k, v in args.items()},
        })

    def counter_sample(self, name: str, **values) -> None:
        """A counter-track sample (Perfetto plots these as time series)."""
        if not self.enabled:
            return
        self._emit({
            "name": name, "cat": "meters", "ph": "C",
            "ts": (time.perf_counter_ns() - self.epoch_ns) / 1e3,
            "pid": self.pid,
            "args": {k: _json_safe(v) for k, v in values.items()},
        })

    # -- inspection / export ----------------------------------------------

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
        self.epoch_ns = time.perf_counter_ns()

    def span_summary(self) -> Dict[str, Dict[str, float]]:
        """Aggregate completed spans by name: count + total milliseconds
        (the compact form BENCH_N.json embeds)."""
        out: Dict[str, Dict[str, float]] = {}
        for ev in self.events():
            if ev.get("ph") != "X":
                continue
            row = out.setdefault(ev["name"], {"count": 0, "total_ms": 0.0})
            row["count"] += 1
            row["total_ms"] = round(row["total_ms"] + ev["dur"] / 1e3, 3)
        return out

    def export(self, path: Optional[str] = None) -> Dict:
        """The Chrome trace-event document; written to ``path`` when given.

        ``otherData.meters`` carries the meters snapshot so one file holds
        the whole observability state.
        """
        from . import meters

        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"meters": meters.snapshot()},
        }
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=1, default=str)
        return doc


#: the process-global tracer every module-level helper routes through
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def enable() -> Tracer:
    _TRACER.enabled = True
    return _TRACER


def disable() -> Tracer:
    _TRACER.enabled = False
    return _TRACER


def reset() -> None:
    _TRACER.reset()


def span(name: str, cat: str = "analysis", **args):
    return _TRACER.span(name, cat, **args)


def current():
    return _TRACER.current()


def instant(name: str, cat: str = "analysis", **args) -> None:
    _TRACER.instant(name, cat, **args)


def counter_sample(name: str, **values) -> None:
    _TRACER.counter_sample(name, **values)


def events() -> List[Dict]:
    return _TRACER.events()


def span_summary() -> Dict[str, Dict[str, float]]:
    return _TRACER.span_summary()


def export(path: Optional[str] = None) -> Dict:
    return _TRACER.export(path)


def traced(name: Optional[str] = None, cat: str = "analysis"):
    """Decorator form of :func:`span` (span name defaults to the function's
    qualified name)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not _TRACER.enabled:
                return fn(*a, **kw)
            with _TRACER.span(label, cat):
                return fn(*a, **kw)

        return wrapper

    return deco


def _other_rank() -> bool:
    """True in a rank other than 0 of a process group of more than one
    rank (``torch.distributed``, looked up only if the process imported
    it)."""
    dist = sys.modules.get("torch.distributed")
    return (dist is not None and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1 and dist.get_rank() != 0)


def log(event: str, **fields) -> None:
    """Structured progress line: ``[event] key=value ...`` on stdout plus an
    instant trace event — the one replacement for ad-hoc CLI prints, so
    human-readable output and the trace never disagree. Inside a process
    group of several ranks only rank 0 prints (a mesh prints each line
    once, as the JAX package's one process does); every rank records the
    event."""
    if not _other_rank():
        parts = " ".join(f"{k}={_json_safe(v)}" for k, v in fields.items())
        print(f"[{event}] {parts}" if parts else f"[{event}]")
    _TRACER.instant(event, cat="log", **fields)


def _init_from_env() -> None:
    val = os.environ.get(ENV_FLAG, "").strip()
    if not val or val == "0" or val.lower() in ("false", "off", "no"):
        return
    enable()
    if val != "1" and val.lower() not in ("true", "on", "yes"):
        atexit.register(lambda: _TRACER.export(val))


_init_from_env()
