"""The optimizer, the learning-rate schedule, and the train and eval steps
(the port of sqair_tpu/training/train.py)."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from ..models.model import Model
from ..ops.noise import NoiseSource

Schedule = Union[float, Callable[[int], float]]


def make_lr_schedule(learning_rate: float, schedule: Optional[str],
                     train_itr: int) -> Schedule:
    """Piecewise-constant decay: '4,6,10' puts boundaries at the cumulative
    proportions round(cumsum(props) train_itr / sum(props)), and the rate is
    multiplied by 1/3 at each boundary but the last (which is train_itr).

    :return: the rate itself without a schedule, else count -> rate
    """
    if not schedule:
        return learning_rate
    props = [float(f) for f in schedule.split(",")]
    cum = np.cumsum(props)
    boundaries = [int(b) for b in np.round(cum * train_itr / cum[-1]).astype(np.int64)[:-1]]

    def rate(count: int) -> float:
        return learning_rate * (1.0 / 3.0) ** sum(count >= b for b in boundaries)

    return rate


class TFRMSProp(torch.optim.Optimizer):
    """RMSProp as TensorFlow's RMSPropOptimizer (decay 0.9, momentum 0.9,
    eps 1e-10) and the JAX package's optax.rmsprop(lr, 0.9, 1e-10, momentum
    0.9, initial_scale=1) compute it; torch.optim.RMSprop differs in three
    places:

      nu <- decay nu + (1 - decay) g^2, with nu starting at ONES
      u  <- -lr_t g rsqrt(nu + eps)        (eps inside the root)
      m  <- u + momentum m                 (the rate applied before the trace)
      p  <- p + m

    ``lr`` is a rate or a schedule count -> rate; the count starts at 0 and
    advances once per step, as optax's.  ``step(lr=t)`` takes the step's
    rate from a 0-dim float32 tensor on the parameters' device instead of
    the schedule (what a captured CUDA graph reads at each replay,
    ``training/graph.py``); holding f32(rate), it gives the same bits.
    """

    DECAY, EPS, MOMENTUM = 0.9, 1e-10, 0.9

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule):
        super().__init__(params, dict(lr=lr))
        self.count = 0

    def rate(self, lr: Schedule) -> float:
        return self.rate_at(lr, self.count)

    @staticmethod
    def initial_state(p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A parameter's state before its first update: nu ones, trace zeros."""
        return dict(nu=torch.ones_like(p), trace=torch.zeros_like(p))

    @staticmethod
    def rate_at(lr: Schedule, count: int) -> float:
        return lr(count) if callable(lr) else lr

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[torch.Tensor] = None):
        """One update; ``lr``: this step's rate as a tensor (see above)."""
        if closure is not None:
            raise ValueError("TFRMSProp takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p] = self.initial_state(p)
            nu = [self.state[p]["nu"] for p in params]
            trace = [self.state[p]["trace"] for p in params]
            # nu <- (1 - decay) g^2 + decay nu
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - self.DECAY)
            torch._foreach_mul_(nu, self.DECAY)
            torch._foreach_add_(nu, sq)
            # u = -lr_t g rsqrt(nu + eps)
            upd = torch._foreach_add(nu, self.EPS)
            torch._foreach_rsqrt_(upd)
            torch._foreach_mul_(upd, grads)
            torch._foreach_mul_(upd, -self.rate(group["lr"]) if lr is None else torch.neg(lr))
            # m <- u + momentum m; p <- p + m
            torch._foreach_mul_(trace, self.MOMENTUM)
            torch._foreach_add_(trace, upd)
            torch._foreach_add_(params, trace)
        self.count += 1


OPTIMIZERS = ("rmsprop",)


def make_optimizer(name: str, learning_rate: Schedule) -> Callable[[Iterable], TFRMSProp]:
    """The optimizer of a flag name, as a factory params -> optimizer.

    Only "rmsprop" is ported; the JAX package's "adam", "sgd" and
    "momentum" raise.
    """
    if name.lower() != "rmsprop":
        raise ValueError(f"optimizer '{name}' is not ported yet (ported: {OPTIMIZERS})")
    return functools.partial(TFRMSProp, lr=learning_rate)


class TrainState:
    """The optimizer bound to the model's parameters, and the step count."""

    def __init__(self, optimizer: torch.optim.Optimizer, step: int = 0):
        self.optimizer, self.step = optimizer, step


def init_train(model: Model, optimizer) -> TrainState:
    """Binds ``optimizer`` (a factory from ``make_optimizer``) to every
    parameter of the model, once each (shared modules are registered under
    one owner, and ``parameters()`` skips repeats by identity)."""
    return TrainState(optimizer(list(model.sequence.parameters())))


def gradient_summaries(grads: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor],
                       params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Gradient and update diagnostics under the JAX package's names
    (sqair_tpu/training/train.py ``gradient_summaries``): the global
    gradient and update norms, the update-to-weight norm ratio, and each
    top-level module's gradient norm.  Each dict maps a parameter's
    state_dict name to a tensor (``updates``: what the step added;
    ``params``: the parameters before it)."""
    def gnorm(tensors):
        return torch.sqrt(sum(torch.sum(t * t) for t in tensors))

    out = {"grads/global_norm": gnorm(grads.values()),
           "grads/update_norm": gnorm(updates.values())}
    out["grads/update_to_weight_ratio"] = out["grads/update_norm"] / (
        gnorm(params.values()) + 1e-12)
    tops = sorted({name.split(".")[0] for name in grads})
    for top in tops:
        out[f"grads/norm/{top}.params"] = gnorm(
            g for name, g in grads.items() if name.split(".")[0] == top)
    return out


def make_grad_fn(model: Model, l2_weight: float = 0.0) -> Callable:
    """(obs, nums, noise) -> {parameter name: gradient} of the train-record
    loss, zeros for a parameter that gets none; the parameters' ``.grad``
    fields are left alone.  For the gradient histograms at the log cadence."""
    named = list(model.sequence.named_parameters())

    def grad_fn(obs, nums, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        obs = torch.as_tensor(obs, dtype=model.dtype, device=model.device)
        nums = torch.as_tensor(nums, dtype=model.dtype, device=model.device)
        target, _ = model.loss_and_metrics(obs, noise, nums, l2_weight=l2_weight,
                                           record_mode="train")
        grads = torch.autograd.grad(target, [p for _, p in named], allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(named, grads)}

    return grad_fn


def named_grad_leaves(grads: Dict[str, torch.Tensor]):
    """('top.params.sub.param', tensor) pairs: the JAX package's histogram
    tags (its flax tree's path) for the port's parameter names."""
    for name, leaf in grads.items():
        top, _, rest = name.partition(".")
        yield f"{top}.params.{rest}", leaf


def make_train_step(model: Model, optimizer, l2_weight: float = 0.0) -> Callable:
    """(obs [T, B, H, W], nums [T, B, C], noise) -> metrics.

    Runs the train record's loss forward and backward on the model's device
    and updates the parameters in place, once per call.  The metrics are
    those of the parameters before the update, as in the JAX package.

    :param optimizer: a factory from ``make_optimizer``
    """
    state = init_train(model, optimizer)

    def train_step(obs, nums, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        device = model.device
        obs = torch.as_tensor(obs, dtype=model.dtype, device=device)
        nums = torch.as_tensor(nums, dtype=model.dtype, device=device)
        state.optimizer.zero_grad(set_to_none=True)
        target, aux = model.loss_and_metrics(obs, noise, nums, l2_weight=l2_weight,
                                             record_mode="train")
        target.backward()
        state.optimizer.step()
        state.step += 1
        return Model.finalize_metrics({k: v.detach() for k, v in aux["metrics"].items()})

    train_step.state = state
    return train_step


def make_eval_step(model: Model) -> Callable:
    """(obs [T, B, H, W], nums [T, B, C], noise) -> metrics, on the model's
    device and under ``torch.inference_mode``."""

    def eval_step(obs, nums, noise: NoiseSource):
        device = model.device
        with torch.inference_mode():
            obs = torch.as_tensor(obs, dtype=model.dtype, device=device)
            nums = torch.as_tensor(nums, dtype=model.dtype, device=device)
            _, aux = model.loss_and_metrics(obs, noise, nums)
            return Model.finalize_metrics(aux["metrics"])

    return eval_step
