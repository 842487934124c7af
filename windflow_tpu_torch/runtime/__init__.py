"""Drivers of the port: the operator chain and the source-to-sink pipeline."""

from .pipeline import CompiledChain, Pipeline

__all__ = ["CompiledChain", "Pipeline"]
