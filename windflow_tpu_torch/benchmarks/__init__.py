"""Benchmark harness utilities of the port."""

from typing import Callable, Optional


def device_cursor_step(chain, src, batch: int, out_fn: Optional[Callable] = None):
    """The bench step with a device-resident cursor:
    ``step(states, cur) -> (states, cur + batch, out_fn(b))``.

    Counterpart of ``windflow_tpu/benchmarks/__init__.py::device_cursor_step``
    without ``jax.jit``: the step runs eagerly, and ``cur`` is an int32 device
    scalar, so no host-to-device copy happens per step. ``out_fn`` picks the
    step output to hang timing on (default: the batch's valid mask)."""
    if out_fn is None:
        out_fn = lambda b: b.valid  # noqa: E731

    def step(states, cur):
        b = src.make_batch(cur, batch)
        states = list(states)
        for j, op in enumerate(chain.ops):
            states[j], b = op.apply(states[j], b)
        return tuple(states), cur + batch, out_fn(b)

    return step
