"""Drivers of the port: the operator chain, the source-to-sink pipeline, the
PipeGraph/MultiPipe composition layer and the builders."""

from .pipegraph import AppNode, MultiPipe, PipeGraph
from .pipeline import CompiledChain, Pipeline, record_source_launch, resolve_batch_hint

__all__ = ["AppNode", "CompiledChain", "MultiPipe", "Pipeline", "PipeGraph",
           "record_source_launch", "resolve_batch_hint"]
