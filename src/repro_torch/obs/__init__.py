"""Observability for the port: the span tracer (``trace``) and the train
telemetry (``telemetry``)."""
from .trace import NULL, NullTracer, Tracer, make_tracer  # noqa: F401
