"""Drivers of the port: the operator chain, the source-to-sink pipeline, the
threaded pipeline, the PipeGraph/MultiPipe composition layer and the builders."""

from .pipegraph import AppNode, MultiPipe, PipeGraph
from .pipeline import CompiledChain, Pipeline, record_source_launch, resolve_batch_hint
from .threaded import ThreadedPipeline

__all__ = ["AppNode", "CompiledChain", "MultiPipe", "Pipeline", "PipeGraph",
           "ThreadedPipeline", "record_source_launch", "resolve_batch_hint"]
