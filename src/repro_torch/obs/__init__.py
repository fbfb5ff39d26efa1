"""Telemetry for the permutation stack: the counterpart of :mod:`repro.obs`.

Three layers, all zero-cost while disabled (the default — every
instrumentation site is one module-attribute check, and nothing is
recorded inside kernels):

* :mod:`.trace`   — hierarchical spans, recorded at dispatch time on the
  host.
* :mod:`.metrics` — labeled counters + histograms: kernel-class
  dispatch counts, DMA descriptors, modeled round trips.
* :mod:`.export`  — ``export_trace(path)`` (Chrome trace / Perfetto
  JSON), ``report()`` (plain-text summary), ``snapshot()`` (the same as
  a dict), ``cache_stats()`` (every executor cache's hits and size).

Quick tour::

    from repro_torch import obs
    obs.enable()
    y = bmmc_permute(x, bmmc)
    print(obs.report())
    obs.reset(); obs.disable()
"""
from .trace import (disable, enable, enabled, events, record_event, reset as
                    _reset_trace, span, sync_enabled)
from .metrics import (class_counts, counter_total, counter_value, counters,
                      histograms, inc, kernel_counts, observe,
                      reset as _reset_metrics)
from .export import (cache_stats, export_trace, model_vs_measured, report,
                     snapshot)


def reset() -> None:
    """Drop all recorded spans, counters and histograms (the enabled
    flag is untouched)."""
    _reset_trace()
    _reset_metrics()


__all__ = [
    "enable", "disable", "enabled", "sync_enabled", "reset", "span",
    "events", "record_event", "inc", "observe", "counters",
    "counter_value", "counter_total", "histograms", "kernel_counts",
    "class_counts", "cache_stats", "export_trace", "model_vs_measured",
    "report", "snapshot",
]
