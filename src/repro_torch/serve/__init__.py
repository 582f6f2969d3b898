"""Serving for the port: paged KV cache, chunked prefill,
continuous-batching scheduler, on-device sampling, serving metrics.

Public surface: ``Engine`` / ``Request`` (engine.py) plus the submodules
``kvcache`` / ``scheduler`` / ``sampling`` / ``metrics``.
"""
from .engine import Engine, Request

__all__ = ["Engine", "Request"]
