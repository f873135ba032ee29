"""Train steps chained N at a time: the port's counterpart of the JAX
package's ``--steps_per_call`` (sqair_tpu/scripts/experiment.py, N jitted
train steps in one ``lax.scan`` per dispatch).

On the card, a call replays one captured ``torch.cuda.CUDAGraph`` of N
train steps: the batch gather, the train-record loss forward and backward
(every kernel of the path) and the RMSProp update, N times, with no host
work between them.  On the CPU the same callable runs the N steps eagerly.

What the capture has to get right:

- Warm-up.  One step runs on a side stream before the capture: it builds
  the kernel library, sets each kernel's shared-memory attribute, makes the
  optimizer's state and the library handles.  The parameters, the
  optimizer's state and count and the generators are put back in place
  afterwards (``TrainSnapshot``), so that the warm-up moves no training.
- The learning rate.  Step i reads its rate (and adam's bias corrections:
  the optimizer's ``scalars_at``) from ``rates[i]``, a device tensor filled
  before each call with their values at the N counts the call covers (a
  host float would be baked into the graph).
- Generators.  The batch indices and the noise come from explicit CUDA
  generators registered with the graph, so each replay draws on from where
  the last one stopped: the same stream for any N.
- Gradients are set to None before the capture and inside every captured
  step, so the captured backward writes them fresh into the graph's pool.
- A graph is valid for the switches it was captured under
  (``SQAIR_FUSE_GLIMPSE``, ``SQAIR_FUSE_CELLS``, read at every step): a
  call under other switches captures again.  ``release`` frees the graph
  and its memory pool (the CLI's curriculum stage boundary).

The kernels' launch counters (``ops/fused.launches``) advance only while a
graph is captured; ``launches`` holds one capture's counts, which every
replay launches again, and ``long_k_calls`` its MLP calls that took the
long-K kernels (``ops/fused.long_k_calls``).  A failed capture or replay raises: nothing falls
back to eager steps on the card.

Tracing (``sqair_tpu_torch/tracing.py``).  Each call advances the chain
call index; ``sqair.chain.rates_fill`` times ``_fill_rates`` (on the card
its copy waits for the last replay to end) and ``sqair.chain.graph_launch``
the replay's launch, both while tracing is on.  ``sqair.chain.prepare``
(the warm-up step ``sqair.chain.warmup``, then ``sqair.chain.capture``) is
recorded always.  The captured graph's first and last nodes are stamps
(``ops/stamp.py``) into the chain's ``stamps`` ring, so each replay leaves
its start and end on the card's clock.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from .. import tracing
from ..models.model import Model
from ..ops import fused, fused_cells, fused_glimpse, stamp
from ..ops.noise import NoiseSource
from .train import TFRMSProp, TrainState, gradient_summaries

Source = Callable[[], Dict[str, torch.Tensor]]


def _switches():
    """The switches a graph is valid for."""
    return fused_glimpse.enabled(), fused_cells.enabled()


class TrainSnapshot:
    """The parameters, the optimizer's state and count, the step and the
    generators' states, to be put back in place: every tensor keeps its
    storage, so a captured graph goes on reading it."""

    def __init__(self, model: Model, state: TrainState, generators: Iterable[torch.Generator]):
        self.state = state
        opt = state.optimizer
        self.params = [(p, p.detach().clone()) for p in model.sequence.parameters()]
        self.opt_state = {p: {k: v.clone() for k, v in st.items()} for p, st in opt.state.items()}
        self.count, self.step = opt.count, state.step
        self.generators = [(g, g.get_state()) for g in generators]

    @torch.no_grad()
    def restore(self):
        opt = self.state.optimizer
        for p, value in self.params:
            p.copy_(value)
            p.grad = None
        for p, st in opt.state.items():
            # a state made since the snapshot goes back to its start
            saved = self.opt_state.get(p) or opt.initial_state(p)
            for k, v in saved.items():
                st[k].copy_(v)
        opt.count, self.state.step = self.count, self.step
        for g, s in self.generators:
            g.set_state(s)


class ChainedTrainStep:
    """A callable that advances training by ``steps`` train steps and
    returns the last step's metrics as device tensors (on the card, the
    graph's own: the next call overwrites them).

    :param source: () -> dict(imgs [T, B, H, W], nums [T, B, C]) on the
        model's device, called once a step: the device sampler's gather, or
        static buffers the caller fills before each call (then steps == 1)
    :param seq_len: the frames of the batch a step trains on
    :param noise: step index -> the step's noise source
    :param generators: every generator that ``source`` and ``noise`` draw
        from (registered with the graph)
    :param grad_summaries: add ``gradient_summaries`` to the metrics
    """

    def __init__(self, model: Model, state: TrainState, source: Source, steps: int,
                 seq_len: int, l2_weight: float, noise: Callable[[int], NoiseSource],
                 generators: Sequence[torch.Generator] = (), grad_summaries: bool = False):
        if len(state.optimizer.param_groups) != 1:
            raise ValueError("the chained step takes an optimizer with one parameter group")
        self.model, self.state, self.source = model, state, source
        self.steps, self.seq_len, self.l2_weight = int(steps), int(seq_len), l2_weight
        self.noise, self.generators = noise, list(generators)
        self.grad_summaries = grad_summaries
        self.device = model.device
        opt = state.optimizer
        n_scalars = len(opt.scalars_at(opt.param_groups[0]["lr"], 0))
        self.rates = torch.zeros((self.steps, n_scalars), dtype=torch.float32,
                                 device=self.device)
        self.stamps = (tracing.StampRing(self.device, stamp.stamp, self.steps)
                       if self.device.type == "cuda" else None)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None
        self.launches: Optional[Dict[str, int]] = None
        self.long_k_calls: Optional[Dict[str, int]] = None

    def _step(self, i: int, itr: int) -> Dict[str, torch.Tensor]:
        """Train step i of the chain, the itr-th of the run."""
        model, opt = self.model, self.state.optimizer
        batch = self.source()
        obs, nums = batch["imgs"][:self.seq_len], batch["nums"][:self.seq_len]
        opt.zero_grad(set_to_none=True)
        target, aux = model.loss_and_metrics(obs, self.noise(itr), nums,
                                             l2_weight=self.l2_weight, record_mode="train")
        target.backward()
        if self.grad_summaries:
            named = dict(model.sequence.named_parameters())
            before = {n: p.detach().clone() for n, p in named.items()}
            grads = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                     for n, p in named.items()}
        opt.step(lr=self.rates[i])
        metrics = Model.finalize_metrics({k: v.detach() for k, v in aux["metrics"].items()})
        if self.grad_summaries:
            # what the step added to each parameter: RMSProp's new trace
            # (optax's update), else the parameter's change
            if isinstance(opt, TFRMSProp):
                updates = {n: opt.state[p]["trace"] if opt.state.get(p) else torch.zeros_like(p)
                           for n, p in named.items()}
            else:
                updates = {n: p.detach() - before[n] for n, p in named.items()}
            metrics.update(gradient_summaries(grads, updates, before))
        return metrics

    def _fill_rates(self):
        opt = self.state.optimizer
        lr = opt.param_groups[0]["lr"]
        rates = [opt.scalars_at(lr, opt.count + i) for i in range(self.steps)]
        self.rates.copy_(torch.tensor(rates, dtype=torch.float32))

    def __call__(self) -> Dict[str, torch.Tensor]:
        tracing.call()
        with tracing.span("sqair.chain.rates_fill"):
            self._fill_rates()
        if self.device.type != "cuda":
            for i in range(self.steps):
                metrics = self._step(i, self.state.step)
                self.state.step += 1
            return metrics
        if self.graph is None or _switches() != self.key:
            self.capture()
        with tracing.span("sqair.chain.graph_launch"):
            self.graph.replay()
        self.stamps.replayed()
        self.state.optimizer.count += self.steps
        self.state.step += self.steps
        return self.metrics

    def capture(self):
        """Warms up, then captures the chain of ``steps`` train steps under
        the current switches, with no effect on the training's state."""
        with tracing.setup_span("sqair.chain.prepare", leaf=False):
            self.release()
            device = self.device
            with tracing.setup_span("sqair.chain.warmup"):
                snapshot = TrainSnapshot(self.model, self.state, self.generators)
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    self._step(0, self.state.step)
                torch.cuda.current_stream(device).wait_stream(side)
                torch.cuda.synchronize(device)
                snapshot.restore()
            with tracing.setup_span("sqair.chain.capture"):
                graph = torch.cuda.CUDAGraph()
                for g in self.generators:
                    graph.register_generator_state(g)
                before = collections.Counter(fused.launches)
                before_long_k = collections.Counter(fused.long_k_calls)
                with torch.cuda.graph(graph):
                    self.stamps.stamp()
                    for i in range(self.steps):
                        metrics = self._step(i, self.state.step + i)
                    self.stamps.stamp()
                self.launches = dict(collections.Counter(fused.launches) - before)
                self.long_k_calls = dict(collections.Counter(fused.long_k_calls) - before_long_k)
                # the capture ran no kernel; this puts back the host's side
                # (the optimizer's count, the gradients' references, the
                # generators)
                snapshot.restore()
        tracing.register(self.stamps)
        self.graph, self.metrics, self.key = graph, metrics, _switches()

    def release(self):
        """Frees the captured graph and its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.metrics = self.key = None


def make_chained_train_step(model: Model, state: TrainState, source: Source, steps: int,
                            seq_len: int, l2_weight: float, noise: Callable[[int], NoiseSource],
                            generators: Sequence[torch.Generator] = (),
                            grad_summaries: bool = False) -> ChainedTrainStep:
    """The chained train step (``ChainedTrainStep``) of ``model`` and the
    optimizer bound to it in ``state`` (``training.init_train``)."""
    return ChainedTrainStep(model, state, source, steps, seq_len, l2_weight, noise,
                            generators, grad_summaries)
