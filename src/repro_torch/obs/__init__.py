"""Observability for the port: the span tracer (``trace``)."""
from .trace import NULL, NullTracer, Tracer, make_tracer  # noqa: F401
