"""Span arithmetic of the readers of the program's own spans and counters
(``lightly_ocr_tpu_torch/utils/profiling.py``).

A span is a ``record_function`` event of the traced window
(``trace.Trace.spans``); its children are the spans of another name opened
inside it on its thread.  Host time is a span's duration; device time is
that of the kernels launched while it is open (``Trace.span_device_ms``);
device-idle time inside spans is the part of them in which the card ran no
operation.  Every function returns None where the trace holds nothing to
read, as a reader must for a program without the span (or without a
card).
"""
from __future__ import annotations

import bisect


def children(span, spans: list) -> list:
    """Those of ``spans`` opened inside ``span`` on its thread."""
    a, b = span["ts"], span["ts"] + span["dur"]
    return [s for s in spans if s["tid"] == span["tid"] and a <= s["ts"] and s["ts"] + s["dur"] <= b]


def host_ms(tr, name: str, per: str) -> float | None:
    """Host ms of the spans ``name`` a ``per`` span."""
    n = len(tr.spans(per))
    spans = tr.spans(name)
    return sum(s["dur"] for s in spans) / 1e3 / n if n and spans else None


def device_ms(tr, name: str, per: str) -> float | None:
    """Device ms of the kernels launched in the spans ``name``, a ``per``
    span."""
    n = len(tr.spans(per))
    spans = tr.spans(name)
    if not n or not spans or not tr.device:
        return None
    return sum(tr.span_device_ms(s) for s in spans) / n


def kernels(tr, name: str) -> float | None:
    """Device operations launched in a span ``name``, on the mean."""
    spans = tr.spans(name)
    if not spans or not tr.device:
        return None
    return sum(len(tr.span_kernels(s)) for s in spans) / len(spans)


def child_ms(tr, name: str, child: str, per: str) -> float | None:
    """Host ms of the spans ``child`` inside the spans ``name``, a ``per``
    span."""
    n = len(tr.spans(per))
    spans, kids = tr.spans(name), tr.spans(child)
    if not n or not spans:
        return None
    return sum(c["dur"] for s in spans for c in children(s, kids)) / 1e3 / n


def self_ms(tr, name: str, child: str, per: str) -> float | None:
    """Host ms of the spans ``name`` less their ``child`` spans, a ``per``
    span."""
    whole, inner = host_ms(tr, name, per), child_ms(tr, name, child, per)
    return None if whole is None or inner is None else whole - inner


def count_in(tr, name: str, per: str) -> float | None:
    """Spans ``name`` opened inside the ``per`` spans, a ``per`` span."""
    outer, inner = tr.spans(per), tr.spans(name)
    if not outer or not inner:
        return None
    return sum(len(children(s, inner)) for s in outer) / len(outer)


def merged(intervals) -> list:
    """Sorted, disjoint [start, end] intervals covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered_us(cover: list, a: float, b: float) -> float:
    """Microseconds of [a, b] that the merged intervals ``cover`` hold."""
    i = max(0, bisect.bisect_right(cover, [a, float("inf")]) - 1)
    total = 0.0
    while i < len(cover) and cover[i][0] < b:
        total += max(0.0, min(b, cover[i][1]) - max(a, cover[i][0]))
        i += 1
    return total


def idle_ms(tr, name: str, per: str) -> float | None:
    """Device-idle ms inside the spans ``name`` (their union, any thread),
    a ``per`` span."""
    n = len(tr.spans(per))
    spans = tr.spans(name)
    if not n or not spans or not tr.device:
        return None
    busy = merged((e["ts"], e["ts"] + e["dur"]) for e in tr.device)
    idle = sum(b - a - covered_us(busy, a, b)
               for a, b in merged((s["ts"], s["ts"] + s["dur"]) for s in spans))
    return idle / 1e3 / n


def counter_mean(rec, name: str) -> float | None:
    """Mean of the program's counter ``name`` over the traced part; None
    where the program keeps no such counter."""
    try:
        from lightly_ocr_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counter_values", None)
    if read is None or rec.get("traced") is None:
        return None
    values = read(name, *rec["traced"])
    return sum(values) / len(values) if values else None
