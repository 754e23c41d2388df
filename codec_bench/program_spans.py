"""The port's own spans and counters over the traced GOPs, for the readers
of the program's per-layer metrics (``metrics/<name>.py``).

``ivclab_tpu_torch/runtime/trace.py`` records while a ``torch.profiler``
records, so a ``--trace 1`` run holds the spans of exactly the slice's
GOPs, plus the next GOP's, which is dispatched before the host sees the
last traced one complete. A port without that recorder gives nothing to
read: every function here then returns ``None``.
"""

from __future__ import annotations

from collections import Counter


def kept(ctx) -> list[dict] | None:
    """The recorder's requests of the first ``ctx.n_traced`` GOPs: for each
    outermost call into the port, its first ``n_traced`` requests; ``None``
    where the run traced nothing or the port records nothing."""
    if ctx.slice is None or not ctx.n_traced:
        return None
    try:
        from ivclab_tpu_torch.runtime import trace
    except ImportError:
        return None
    read = getattr(trace, "requests", None)
    requests = read() if callable(read) else None
    if not requests:
        return None
    seen: Counter = Counter()
    out = []
    for r in requests:
        if seen[r["name"]] < ctx.n_traced:
            seen[r["name"]] += 1
            out.append(r)
    return out


def span_ms(ctx, names: tuple[str, ...], field: str = "host_ms") -> float | None:
    """ms a GOP inside the spans named ``names`` (``field`` ``host_ms`` or
    ``device_ms``); ``None`` where no such span was recorded or one has no
    device time."""
    requests = kept(ctx)
    if requests is None:
        return None
    ms = [s[field] for r in requests for s in r["spans"] if s["name"] in names]
    if not ms or any(v is None for v in ms):
        return None
    return sum(ms) / ctx.n_traced


def counted(ctx, names: tuple[str, ...]) -> float | None:
    """The counters ``names`` summed a GOP (0 where the traced requests
    never touched them); ``None`` where nothing was recorded."""
    requests = kept(ctx)
    if requests is None:
        return None
    return sum(s["counts"].get(n, 0) for r in requests for s in r["spans"]
               for n in names) / ctx.n_traced
