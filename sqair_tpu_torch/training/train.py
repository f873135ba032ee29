"""The optimizer, the learning-rate schedule, and the train and eval steps
(the port of sqair_tpu/training/train.py)."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

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


def is_disc_steps_kernel(name: str) -> bool:
    """Whether a state_dict name is the discovery steps predictor's
    first-layer kernel (``...discover...steps_predictor...w_0``), the one
    whose last rows the coverage signal appends; the propagation steps
    predictor has no discovery ancestor.  The JAX package's test on a
    parameter path (sqair_tpu/training/train.py ``is_disc_steps_kernel``)."""
    keys = name.split(".")
    return (keys[-1] == "w_0" and "steps_predictor" in keys
            and any("disc" in k for k in keys[:-1]))


class TensorRateOptimizer(torch.optim.Optimizer):
    """An optimizer whose step can read its per-step numbers from a device
    tensor (what a captured CUDA graph reads at each replay,
    ``training/graph.py``), with optax's step count.

    ``lr`` is a rate or a schedule count -> rate; the count starts at 0 and
    advances once per step, as optax's.  ``scalars_at(count)`` are the
    numbers a step needs (the rate, and for adam its bias corrections); a
    step reads them from a float32 tensor on the parameters' device:
    ``step(lr=t)`` takes t, ``step()`` makes it from the schedule, so that
    both give the same bits.  ``STATE`` names each parameter's state
    tensors.

    ``row_scales`` {parameter: (n, mult)} multiplies the update of the last
    n rows of a parameter by mult after the optimizer's own rule, leaving
    its state as it is (``scale_coverage_row_updates``).
    """

    STATE: Tuple[str, ...] = ()

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule):
        super().__init__(params, dict(lr=lr))
        self.count = 0
        self.row_scales: Dict[torch.Tensor, Tuple[int, float]] = {}

    @staticmethod
    def rate_at(lr: Schedule, count: int) -> float:
        return lr(count) if callable(lr) else lr

    def rate(self, lr: Schedule) -> float:
        return self.rate_at(lr, self.count)

    def scalars_at(self, lr: Schedule, count: int) -> Tuple[float, ...]:
        return (self.rate_at(lr, count),)

    def initial_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A parameter's state before its first update."""
        return {k: torch.zeros_like(p) for k in self.STATE}

    def _update(self, params, grads, states, scalars) -> List[torch.Tensor]:
        """The updates to add to ``params`` (their state updated in place).

        :param scalars: ``scalars_at``'s numbers, 0-dim float32 tensors on
            the device
        """
        raise NotImplementedError

    def _apply(self, params, updates):
        """p <- p + u, with the rows of ``row_scales`` scaled (a scaled
        update is a new tensor: the optimizer's state keeps its own)."""
        plain_p, plain_u = [], []
        for p, u in zip(params, updates):
            if p in self.row_scales:
                n, mult = self.row_scales[p]
                p[:-n].add_(u[:-n])
                p[-n:].add_(u[-n:] * mult)
            else:
                plain_p.append(p)
                plain_u.append(u)
        if plain_p:
            torch._foreach_add_(plain_p, plain_u)

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[torch.Tensor] = None):
        """One update; ``lr``: this step's numbers as a tensor (see above)."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p] = self.initial_state(p)
            if lr is None:
                lr = torch.tensor(self.scalars_at(group["lr"], self.count),
                                  dtype=torch.float32, device=params[0].device)
            scalars = tuple(lr.reshape(-1).unbind(0))
            updates = self._update(params, [p.grad for p in params],
                                   [self.state[p] for p in params], scalars)
            self._apply(params, updates)
        self.count += 1


class TFRMSProp(TensorRateOptimizer):
    """RMSProp as TensorFlow's RMSPropOptimizer (decay 0.9, momentum 0.9,
    eps 1e-10) and the JAX package's optax.rmsprop(lr, 0.9, 1e-10, momentum
    0.9, initial_scale=1) compute it; torch.optim.RMSprop differs in three
    places:

      nu <- decay nu + (1 - decay) g^2, with nu starting at ONES
      u  <- -lr_t g rsqrt(nu + eps)        (eps inside the root)
      m  <- u + momentum m                 (the rate applied before the trace)
      p  <- p + m
    """

    DECAY, EPS, MOMENTUM = 0.9, 1e-10, 0.9
    STATE = ("nu", "trace")

    def initial_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """nu ones, trace zeros."""
        return dict(nu=torch.ones_like(p), trace=torch.zeros_like(p))

    def _update(self, params, grads, states, scalars):
        (lr,) = scalars
        nu = [st["nu"] for st in states]
        trace = [st["trace"] for st in states]
        # nu <- (1 - decay) g^2 + decay nu
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.DECAY)
        torch._foreach_mul_(nu, self.DECAY)
        torch._foreach_add_(nu, sq)
        # u = -lr_t g rsqrt(nu + eps)
        upd = torch._foreach_add(nu, self.EPS)
        torch._foreach_rsqrt_(upd)
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(upd, torch.neg(lr))
        # m <- u + momentum m; the update is m
        torch._foreach_mul_(trace, self.MOMENTUM)
        torch._foreach_add_(trace, upd)
        return trace


class Adam(TensorRateOptimizer):
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the root,
    bias-corrected moments, all in float32:

      mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu
      u  <- -lr_t (mu / c1) / (sqrt(nu / c2) + eps),  c_i = 1 - b_i^(count + 1)

    The bias corrections are per-step numbers (``scalars_at``), so that a
    captured graph reads them from its tensor as it reads the rate."""

    B1, B2, EPS = 0.9, 0.999, 1e-8
    STATE = ("mu", "nu")

    def scalars_at(self, lr, count):
        t = count + 1
        c1 = float(np.float32(1.0) - np.float32(self.B1) ** np.float32(t))
        c2 = float(np.float32(1.0) - np.float32(self.B2) ** np.float32(t))
        return (self.rate_at(lr, count), c1, c2)

    def _update(self, params, grads, states, scalars):
        lr, c1, c2 = scalars
        mu = [st["mu"] for st in states]
        nu = [st["nu"] for st in states]
        g1 = torch._foreach_mul(grads, 1.0 - self.B1)
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, g1)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.B2)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_add_(nu, sq)
        mu_hat = torch._foreach_div(mu, c1)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        torch._foreach_div_(mu_hat, den)
        torch._foreach_mul_(mu_hat, torch.neg(lr))
        return mu_hat


class SGD(TensorRateOptimizer):
    """optax.sgd(lr): u = -lr_t g."""

    def _update(self, params, grads, states, scalars):
        (lr,) = scalars
        return torch._foreach_mul(grads, torch.neg(lr))


class Momentum(TensorRateOptimizer):
    """optax.sgd(lr, momentum=0.9): trace <- g + 0.9 trace (no dampening,
    not Nesterov), u = -lr_t trace."""

    MOMENTUM = 0.9
    STATE = ("trace",)

    def _update(self, params, grads, states, scalars):
        (lr,) = scalars
        trace = [st["trace"] for st in states]
        torch._foreach_mul_(trace, self.MOMENTUM)
        torch._foreach_add_(trace, grads)
        return torch._foreach_mul(trace, torch.neg(lr))


OPTIMIZERS = {"rmsprop": TFRMSProp, "adam": Adam, "sgd": SGD, "momentum": Momentum}


def make_optimizer(name: str, learning_rate: Schedule) -> Callable[..., TensorRateOptimizer]:
    """The optimizer of a flag name (rmsprop, adam, sgd, momentum), as a
    factory params -> optimizer."""
    cls = OPTIMIZERS.get(name.lower())
    if cls is None:
        raise ValueError(f"Unknown optimizer '{name}' (choose from {sorted(OPTIMIZERS)})")
    return functools.partial(cls, lr=learning_rate)


def scale_coverage_row_updates(optimizer: Callable[..., TensorRateOptimizer], mult: float,
                               named_params: Iterable[Tuple[str, torch.Tensor]],
                               n_rows: int = 16) -> Callable[..., TensorRateOptimizer]:
    """A per-row learning rate for the coverage input rows: wraps an
    optimizer factory so that the last ``n_rows`` rows of the discovery
    steps predictor's first-layer kernel (``is_disc_steps_kernel`` among
    ``named_params``, e.g. ``model.sequence.named_parameters()``; the rows
    ``disc_coverage_signal`` appends) have their UPDATES multiplied by
    ``mult``.  Each optimizer applies its rate last, so this is those rows
    at lr mult, while the optimizer's state stays the inner optimizer's:
    checkpoints of unwrapped runs restore."""
    rows = [p for name, p in named_params if is_disc_steps_kernel(name) and p.ndim == 2]

    def factory(params):
        opt = optimizer(params)
        for p in rows:
            opt.row_scales[p] = (n_rows, float(mult))
        return opt

    return factory


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
