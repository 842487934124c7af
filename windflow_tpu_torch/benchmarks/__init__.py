"""Benchmark harness utilities of the port."""

from typing import Callable, Optional

from ..runtime.graphs import StepGraph


def device_cursor_step(chain, src, batch: int, out_fn: Optional[Callable] = None):
    """The bench step with a device-resident cursor:
    ``step(states, cur) -> (states, cur + batch, out_fn(b))``.

    Counterpart of ``windflow_tpu/benchmarks/__init__.py::device_cursor_step``
    (``jax.jit(step, donate_argnums=(0, 1))``). ``cur`` is an int32 device
    scalar, so no host-to-device copy happens per step. ``out_fn`` picks the
    step output to hang timing on (default: the batch's valid mask).

    On a CUDA chain the whole step (``make_batch`` from the cursor, every
    ``apply``, ``out_fn``) is one CUDA graph (:class:`CapturedStep`): the
    states and cursor passed in are consumed, as JAX's donated arguments
    are. On the CPU it is the plain eager step."""
    if out_fn is None:
        out_fn = lambda b: b.valid  # noqa: E731

    def step(states, cur):
        b = src.make_batch(cur, batch)
        states = list(states)
        for j, op in enumerate(chain.ops):
            states[j], b = op.apply(states[j], b)
        return tuple(states), cur + batch, out_fn(b)

    if chain.device.type != "cuda":
        return step
    return CapturedStep(step)


class CapturedStep:
    """A bench step ``(states, cur) -> (states, cur, out)`` run as one CUDA
    graph replay. The first call is one eager step, which builds, loads and
    sets up every kernel of it; the graph is captured right after, over the
    states that step returned, and every later call replays it (its
    outputs cloned out of the graph's pool)."""

    def __init__(self, step: Callable):
        self.step = step
        self.graph: Optional[StepGraph] = None

    def __call__(self, states, cur):
        if self.graph is None:
            states, cur, out = self.step(states, cur)
            self.graph = StepGraph(lambda carry, _: self._carried(*carry),
                                   (states, cur), ())
            return states, cur, out
        (states, cur), out = self.graph.run((states, cur))
        return states, cur, out

    def _carried(self, states, cur):
        states, cur, out = self.step(states, cur)
        return (states, cur), out
