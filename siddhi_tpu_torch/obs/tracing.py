"""Span helpers (port of ``maybe_span``/``NOOP_SPAN`` from
siddhi_tpu/obs/tracing.py). The chunk tracer is not ported yet, so an
app runtime carries no ``tracer`` and every span is the no-op span: the
hot path pays one attribute lookup."""
from __future__ import annotations


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        """Post-hoc arg attribution (no-op when tracing is off)."""


NOOP_SPAN = _NoopSpan()


def maybe_span(app, kind: str, name: str, **args):
    """Span against ``app.tracer`` when the owner is wired to an app
    runtime that traces, else a no-op."""
    tracer = getattr(app, "tracer", None) if app is not None else None
    if tracer is None:
        return NOOP_SPAN
    return tracer.span(kind, name, **args)
