"""The system under test: the program's training path as its CLI composes
it with ``--on_device_data --steps_per_call N`` (``scripts/experiment.py``
``_train``): the configuration's model, ``training.init_train`` over the
optimizer its flags name, batches gathered on the device by
``data.DeviceDatasetSampler``, noise drawn from explicit generators on the
device, and ``training.graph.make_chained_train_step``, whose every call
on the card replays one CUDA graph of N train steps.

Each step's noise source is the program's own (``ops.noise.GeneratorNoise``
on the registered generator, as the CLI builds it).  A ``Recorder`` rides on
that path, armed for the chain's first call only (its capture, on the
card), and records the first ``steps`` train steps for the comparison that
decides ``correct``: at the start of steps 2 to steps + 1 it copies the
weights (what the steps before left) and, at the start of step 2,
RMSProp's state (what step 1's gradient made of it); after each
step's loss, the loss itself; and it keeps the noise tables that those
steps' sources record.  Captured into the graph, the copies run again in
every replay: a few small copies a call.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch


def sub_seed(seed: int, k: int) -> int:
    """The k-th generator seed of a run's ``--seed``."""
    return (int(seed) * 8 + k) % 2**63


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Recorder:
    """See the module's docstring."""

    def __init__(self, named_params, optimizer, steps: int, device):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.optimizer, self.steps, self.device = optimizer, steps, device
        numel = sum(p.numel() for p in self.params)
        self.losses = torch.zeros(steps, dtype=torch.float32, device=device)
        self.snapshots = torch.zeros((steps, numel), dtype=torch.float32, device=device)
        self.opt_state = {k: torch.zeros(numel, dtype=torch.float32, device=device)
                          for k in ("trace", "nu")}
        self.armed = False
        self.sources = self.targets = 0
        self.tables: List[Dict] = []

    def active(self) -> bool:
        """Within the armed call: on the card, only while it is captured
        (not in the warm-up step before the capture)."""
        return self.armed and (self.device.type != "cuda" or _capturing(self.device))

    @torch.no_grad()
    def on_source(self):
        if not self.active():
            return
        j = self.sources
        self.sources += 1
        if 1 <= j <= self.steps:
            torch.cat([p.detach().reshape(-1) for p in self.params], out=self.snapshots[j - 1])
        if j == 1:
            # a leaf that got no gradient has no state: as if its gradient
            # were nought (trace 0, nu 1)
            state = self.optimizer.state
            for key, kept in self.opt_state.items():
                torch.cat([state[p][key].reshape(-1) if state.get(p) else
                           p.new_full((p.numel(),), float(key == "nu")) for p in self.params],
                          out=kept)

    @torch.no_grad()
    def on_target(self, target):
        if not self.active():
            return
        if self.targets < self.steps:
            self.losses[self.targets].copy_(target.detach())
        self.targets += 1

    def wants_noise(self) -> bool:
        """Whether the next step's noise is one of the first ``steps``'."""
        return self.active() and len(self.tables) < self.steps

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, at = {}, 0
        for name, p in zip(self.names, self.params):
            out[name] = flat[at:at + p.numel()].view(p.shape).clone()
            at += p.numel()
        return out

    def readings(self) -> Dict:
        """What the armed call recorded, copied out of the graph's buffers."""
        return dict(losses=[float(v) for v in self.losses.cpu()],
                    trace=self.unflatten(self.opt_state["trace"]),
                    nu=self.unflatten(self.opt_state["nu"]),
                    params=self.unflatten(self.snapshots[self.steps - 1]),
                    noise=[{k: v.clone() for k, v in t.items()} for t in self.tables])


class _RecordingModel:
    """The program's model, with each loss handed to the recorder."""

    def __init__(self, model, recorder: Recorder):
        self._model, self._recorder = model, recorder

    def __getattr__(self, name):
        return getattr(self._model, name)

    def loss_and_metrics(self, *args, **kwargs):
        target, aux = self._model.loss_and_metrics(*args, **kwargs)
        self._recorder.on_target(target)
        return target, aux


def set_switches(switches: Mapping[str, str]):
    """The program's kernel switches (environment variables it reads at
    every step), exactly as the traffic gives them."""
    for name in ("SQAIR_FUSE_GLIMPSE", "SQAIR_FUSE_CELLS"):
        os.environ.pop(name, None)
    os.environ.update({k: str(v) for k, v in switches.items()})


class Training:
    """The program's training object of one run (see the module's
    docstring), built from the benchmark's data and weights."""

    def __init__(self, config: Dict, traffic: Dict, data: Dict[str, torch.Tensor],
                 weights: Dict[str, torch.Tensor], mean_img: np.ndarray, seed: int,
                 device, checked_steps: int):
        from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model
        from sqair_tpu_torch.data import DeviceDatasetSampler
        from sqair_tpu_torch.ops.noise import GeneratorNoise
        from sqair_tpu_torch.training import init_train
        from sqair_tpu_torch.training.graph import make_chained_train_step

        from .weights import load

        self.device = torch.device(device)
        loader = conv_mnist_model if config["model"] == "conv" else mlp_mnist_model
        F = config["flags"]
        self.model = loader.load(F, tuple(config["img_size"]), mean_img=mean_img,
                                 device=self.device)
        load(self.model.sequence, weights)
        factory, l2 = loader.make_optimizer(F)
        self.state = init_train(self.model, factory)
        self.sampler = DeviceDatasetSampler(data, self.device)
        self.batch = int(traffic["batch_size"])
        self.g_data = torch.Generator(device=self.device).manual_seed(sub_seed(seed, 1))
        self.g_noise = torch.Generator(device=self.device).manual_seed(sub_seed(seed, 2))
        self.recorder = Recorder(list(self.model.sequence.named_parameters()),
                                 self.state.optimizer, checked_steps, self.device)

        def source():
            self.recorder.on_source()
            return self.sampler.sample(self.g_data, self.batch)

        def noise(itr):
            source = GeneratorNoise(self.g_noise, self.device,
                                    record=self.recorder.wants_noise())
            if source.table is not None:
                self.recorder.tables.append(source.table)
            return source

        self.chain = make_chained_train_step(
            _RecordingModel(self.model, self.recorder), self.state, source,
            int(traffic["steps_per_call"]), int(traffic["seq_len"]), l2, noise,
            [self.g_data, self.g_noise])

    def first_call(self) -> Dict:
        """The chain's first call (on the card: warm-up, capture and the
        first replay), with the recorder armed; returns its readings."""
        self.recorder.armed = True
        try:
            self.chain()
        finally:
            self.recorder.armed = False
        self.sync()
        return self.recorder.readings()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float):
        """Calls the chain back to back for ``seconds`` of the host's clock,
        never more than two calls ahead of the device, then waits for the
        device.  Returns (calls, wall seconds, the last call's loss, the
        device's ms from each call's end to the next's)."""
        ends: List[torch.cuda.Event] = []
        calls = 0
        t0 = time.perf_counter()
        while True:
            metrics = self.chain()
            calls += 1
            if self.device.type == "cuda":
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
                if len(ends) > 2:
                    ends[-3].synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        wall = time.perf_counter() - t0
        call_ms = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
        return calls, wall, float(metrics["target"]), call_ms

    def launches(self) -> Optional[Dict[str, int]]:
        """The kernel launches of one call, as its capture counted them."""
        return self.chain.launches

    def release(self):
        """Frees the graph and every tensor of the program's state."""
        self.chain.release()
        for name in ("chain", "model", "state", "sampler", "recorder"):
            setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
