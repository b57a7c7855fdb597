"""repro_torch.obs — zero-dependency tracing + metrics for the analysis stack.

The instrumentation substrate every pipeline seam emits into:

* `trace` — hierarchical spans (context manager / decorator, thread-safe),
  exported as Chrome trace-event JSON viewable in Perfetto; global tracer
  with an env (``REPRO_TRACE``) / flag kill-switch. Disabled tracing costs
  one boolean check per seam.
* `meters` — counters, gauges, histograms plus samplers for process RSS,
  CUDA device memory, and host->device transfer bytes.

Span names match the JAX package's, so traces of the two can be compared.

Typical use::

    from repro_torch import obs

    obs.enable()
    with obs.span("sweep", families=12) as sp:
        ...
        sp.set(levels=7)
    obs.export("trace.json")      # -> load in https://ui.perfetto.dev
"""
from . import meters, trace  # noqa: F401
from .meters import (  # noqa: F401
    counter, device_memory_mb, gauge, histogram, peak_rss_mb, record_h2d,
    rss_mb, sample_process, snapshot,
)
from .trace import (  # noqa: F401
    NULL_SPAN, Tracer, counter_sample, current, disable, enable, enabled,
    events, export, get_tracer, instant, log, reset, span, span_summary,
    traced,
)
