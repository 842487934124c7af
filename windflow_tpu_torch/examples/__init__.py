"""The user-facing examples, as modules of the port.

Counterparts of the JAX package's ``examples/0N_*.py``, with the same
constants, sources, operators, oracles and assertions. Each runs on the card
(``python -m windflow_tpu_torch.examples.<name>``), or on the CPU with
``--device cpu``; without a card and without ``--device cpu`` it raises, as
the port's entry points do. Each prints the JAX example's result lines with
the same numbers, and before its last line one JSON line
``{"launches": {kernel: n}}``: the launches of every hand-written kernel it
reached (none on the CPU, where every kernel takes its plain version).

:data:`EXAMPLES` maps each example, in the order a user meets them, to the
kernels its run on the card must launch (``ops/registry.py`` names).
``serving`` runs Nexmark Q1, a stateless ``Map``: it reaches no kernel.
"""

EXAMPLES = {
    "ysb_windows": ("histogram", "lookup"),
    "wordcount": ("lookup", "segment_fold"),
    "checkpoint_resume": ("lookup", "segment_fold", "segment_fold_float"),
    "multichip": ("histogram", "segment_fold_float"),
    "recovery_and_backpressure": ("lookup", "segment_fold", "masked_window_reduce"),
    "serving": (),
}

__all__ = ["EXAMPLES"]
