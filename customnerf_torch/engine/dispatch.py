"""K steps a dispatch on the card: one captured step, replayed per batch.

The JAX package scans K train steps in one program (``lax.scan`` in
``Trainer._multi_step_fn`` and ``editing._build_editing_many``) so that a
dispatch costs the host one call.  The card's form of that scan is a CUDA
graph: :class:`StepGraph` captures ONE step on static input buffers and
replays it once a batch, each replay reading the batch that was copied into
those buffers just before it (a device copy enqueued on the same stream).

One step replayed K times, rather than K steps captured in one graph:

  * the graph's private memory pool holds one step's activations, whatever
    K is, and the last, shorter group of an epoch replays the same graph;
  * a dispatch costs K graph launches and K small input copies instead of
    one launch; each is a few microseconds against a step's milliseconds.

Capture follows ``torch.cuda.graphs``: warm-up steps on a side stream (the
kernels' library, cuBLAS and cuDNN choose and allocate there, not during
capture), then the capture.  The warm-up steps are not training steps: the
parameters, the optimizer's state, the update counter and the random
generator are put back as they were before them, so that the first replay
takes the same step an eager call would.  The trainer's ``torch.Generator``
is registered with the graph: each replay draws fresh numbers, in the order
and with the values an eager step would draw at that point of the stream.

A capture that fails raises :class:`CaptureError`, naming the operation of
the port that broke it; nothing falls back to eager steps.

The hand-written kernels count their launches themselves on the card
(``ops/kernels.py::device_launches``): the warm-up steps' and every
replay's, though a replay runs no wrapper; a capture launches nothing.

The tracer (``engine/spans.py``) sees a replay as the host spans
``replay.copy`` and ``replay``; the device spans of a step captured with
the tracer on are stamps in the graph, so each replay records them (the
trainer counts captures: ``Trainer._step_graph``).
"""

from __future__ import annotations

import os
import traceback

import torch

from customnerf_torch.engine import spans

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARMUP_STEPS = 3


class CaptureError(RuntimeError):
    """A step could not be captured as a CUDA graph."""


def _where(exc: BaseException) -> str:
    """The innermost frame of the port (outside this module) in ``exc``'s
    traceback or in that of the exception it arose from."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if f.filename.startswith(_PKG_DIR)
                  and not f.filename.endswith("dispatch.py")]
        if frames:
            f = frames[-1]
            return (f"{os.path.relpath(f.filename, os.path.dirname(_PKG_DIR))}"
                    f":{f.lineno} in {f.name}: {f.line}")
        exc = exc.__cause__ or exc.__context__
    return "an operation outside the port"


class SavedState:
    """A copy of the tensors a step updates in place — ``tensors`` and the
    optimizer's ``state`` mapping, whose entries a first step creates — and
    of ``generator``'s state; :meth:`restore` writes them back into the same
    tensors (entries created since are zeroed: a fresh Adam state)."""

    def __init__(self, tensors, optimizer_state, generator):
        self.tensors, self.optimizer_state = list(tensors), optimizer_state
        self.generator = generator
        self.saved = [t.detach().clone() for t in self.tensors]
        self.saved_opt = {p: {k: v.detach().clone() for k, v in s.items()
                              if torch.is_tensor(v)}
                          for p, s in optimizer_state.items()}
        self.gen_state = generator.get_state()

    @torch.no_grad()
    def restore(self):
        for t, s in zip(self.tensors, self.saved):
            t.copy_(s)
        for p, s in self.optimizer_state.items():
            for k, v in s.items():
                if not torch.is_tensor(v):
                    continue
                if k in self.saved_opt.get(p, {}):
                    v.copy_(self.saved_opt[p][k])
                else:
                    v.zero_()             # a fresh state: zero moments, step 0
        self.generator.set_state(self.gen_state)


class StepGraph:
    """``step(inputs) -> {name: tensor}`` captured once on copies of
    ``inputs`` (a dict of CUDA tensors) and replayed by :meth:`replay`.

    ``state`` lists the tensors the step updates in place (parameters,
    counters) and ``optimizer_state`` is the optimizer's ``state`` mapping:
    both, and ``generator``, are put back after the warm-up and the
    capture (:class:`SavedState`)."""

    def __init__(self, name, step, inputs: dict, generator, state,
                 optimizer_state):
        self.static_in = {k: v.detach().clone() for k, v in inputs.items()}
        saved = SavedState(state, optimizer_state, generator)
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    step(self.static_in)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(generator)
            try:
                with torch.cuda.graph(self.graph,
                                      capture_error_mode="thread_local"):
                    self.static_out = step(self.static_in)
            except Exception as e:
                raise CaptureError(
                    f"capturing the {name} step as a CUDA graph failed at "
                    f"{_where(e)} ({type(e).__name__}: {e}); run eager steps "
                    f"with --steps_per_dispatch 1") from e
        finally:
            saved.restore()

    def replay(self, inputs: dict) -> dict:
        """One step on ``inputs``: copied into the static buffers, then the
        graph.  The outputs are the graph's own tensors, overwritten by the
        next replay."""
        with spans.span("replay.copy"):
            for k, buf in self.static_in.items():
                buf.copy_(inputs[k])
        with spans.span("replay"):
            self.graph.replay()
        return self.static_out
