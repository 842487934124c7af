"""Parallel window patterns — Key_FFAT only, in this slice.

Counterpart of ``windflow_tpu/operators/win_patterns.py::Key_FFAT`` (reference
``wf/key_ffat.hpp:65-246``): a Key_Farm whose workers are Win_SeqFFAT. On one
device the ``[K]`` key axis of the pane ring is the farm; ``shard_axis``
records the axis a multi-device port would shard. Win_Farm, Key_Farm,
Pane_Farm, Win_MapReduce and Nested_Farm come with ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from ..basic import pattern_t, DEFAULT_MAX_KEYS
from .window import WindowSpec
from .win_seqffat import Win_SeqFFAT


class Key_FFAT(Win_SeqFFAT):
    pattern = pattern_t.KFF_CPU
    shard_axis = "key"

    def __init__(self, lift, combine, *, spec: WindowSpec, parallelism: int = 1,
                 num_keys: int = DEFAULT_MAX_KEYS, name: str = "key_ffat", **kw):
        super().__init__(lift, combine, spec=spec, num_keys=num_keys, name=name,
                         parallelism=parallelism, **kw)
