"""Export + rendering: Chrome-trace JSON and the ``obs.report()`` table.

``export_trace(path)`` writes the recorded spans as a Chrome trace
(``chrome://tracing`` / Perfetto `ui.perfetto.dev` both open it).
``report()`` renders the counters, histograms, cache stats and the
model-vs-measured accounting as one plain-text summary; ``snapshot()``
is the same content as a JSON-serializable dict.
"""
from __future__ import annotations

import json

from . import metrics as _metrics
from . import trace as _trace


def export_trace(path: str) -> str:
    """Write the span buffer as Chrome-trace JSON; returns ``path``."""
    payload = {
        "traceEvents": _trace.events(),
        "displayTimeUnit": "ms",
        "otherData": {"source": "repro_torch.obs",
                      "dropped": _trace.dropped()},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
        f.write("\n")
    return path


def _fmt_key(key: tuple) -> str:
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def cache_stats() -> dict:
    """Aggregate executor/ops cache stats (see
    :func:`repro_torch.combinators.execute.cache_stats`)."""
    from ..combinators.execute import cache_stats as _cs
    return {name: info._asdict() for name, info in _cs().items()}


def snapshot() -> dict:
    """JSON-serializable summary of everything recorded so far."""
    return {
        "kernel_counts": _metrics.kernel_counts(),
        "class_counts": _metrics.class_counts(),
        "counters": {_fmt_key(k): v for k, v in
                     sorted(_metrics.counters().items())},
        "histograms": {_fmt_key(k): s for k, s in
                       sorted(_metrics.histograms().items())},
        "caches": cache_stats(),
        "trace_events": len(_trace.events()),
        "model_vs_measured": model_vs_measured(),
    }


def model_vs_measured() -> dict:
    """Modeled round trips and DMA descriptors accumulated at dispatch
    time vs the measured (sync) wall-clock of the program-call
    histogram."""
    rt = _metrics.counter_total("model.round_trips")
    desc = _metrics.counter_total("dma.descriptors")
    calls = 0
    wall_us = 0.0
    for (name, _), s in _metrics.histograms().items():
        if name == "program.call_us":
            calls += s["count"]
            wall_us += s["sum"]
    out = {
        "modeled_round_trips": int(rt),
        "modeled_dma_descriptors": int(desc),
        "program_calls": int(calls),
        "measured_wall_us": round(wall_us, 1),
    }
    if rt and wall_us:
        out["us_per_modeled_round_trip"] = round(wall_us / rt, 3)
    return out


def _table(rows: list, headers: tuple) -> list:
    widths = [len(h) for h in headers]
    srows = [[str(c) for c in r] for r in rows]
    for r in srows:
        widths = [max(w, len(c)) for w, c in zip(widths, r)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip()]
    lines.append("  ".join("-" * w for w in widths))
    for r in srows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return lines


def report(file=None) -> str:
    """Render the telemetry summary; printed to ``file`` when given."""
    lines = ["== repro_torch.obs report =="]
    state = ("enabled" if _trace.enabled() else "disabled")
    lines.append(f"telemetry: {state} (sync="
                 f"{_trace._state.sync}); spans recorded: "
                 f"{len(_trace.events())} (dropped {_trace.dropped()})")

    kc = _metrics.kernel_counts()
    if kc:
        lines.append("")
        lines.append("-- kernel dispatches (program_cost vocabulary) --")
        lines.extend(_table(sorted(kc.items()), ("kernel", "count")))
    cc = _metrics.class_counts()
    if cc:
        lines.append("")
        lines.append("-- BMMC classes dispatched --")
        lines.extend(_table(sorted(cc.items()), ("class", "count")))

    other = [(_fmt_key(k), v) for k, v in sorted(_metrics.counters().items())
             if k[0] not in ("dispatch.kernel", "dispatch.class")]
    if other:
        lines.append("")
        lines.append("-- counters --")
        lines.extend(_table(other, ("counter", "value")))

    hists = _metrics.histograms()
    if hists:
        lines.append("")
        lines.append("-- histograms (µs unless noted) --")
        rows = [(_fmt_key(k), s["count"], f"{s['mean']:.1f}",
                 f"{s['p50']:.1f}", f"{s['p99']:.1f}", f"{s['max']:.1f}")
                for k, s in sorted(hists.items())]
        lines.extend(_table(rows, ("histogram", "n", "mean", "p50",
                                   "p99", "max")))

    mm = model_vs_measured()
    lines.append("")
    lines.append("-- model vs measured --")
    lines.extend(_table(sorted(mm.items()), ("quantity", "value")))

    caches = cache_stats()
    lines.append("")
    lines.append("-- caches --")
    rows = [(name, c["hits"], c["misses"], c["currsize"],
             c["maxsize"] if c["maxsize"] is not None else "-")
            for name, c in sorted(caches.items())]
    lines.extend(_table(rows, ("cache", "hits", "misses", "size", "max")))

    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text
