"""NN primitives: MLP and recurrent cells (the port of sqair_tpu/nn/layers.py).

Parameters keep the JAX package's names and layouts (MLP weights
``w_i`` [d_in, d_out], ``b_i``; cells ``in_to_hidden_w``, ``gates_xw``, ...),
so a flax parameter tree converts to a ``state_dict`` by renaming
(convert.py).  Modules take their input widths at construction, since
PyTorch creates parameters eagerly.

Cells follow the JAX interface ``cell(state, x) -> (new_state, output)``
with ``state`` a tuple ``(h,)``; ``initial_state(batch)`` tiles the
trainable ``h0``.

Each parameter records its flax initialiser; ``init_params(module,
generator)`` draws them all.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops import fused

State = Tuple[torch.Tensor, ...]

# flax's lecun_normal / truncated_normal: a normal truncated to 2 std,
# rescaled so that the truncated distribution has the requested std
_TRUNC_STD = 0.87962566103423978


def zeros(t, g):
    t.zero_()


def const(value):
    def init(t, g):
        t.fill_(value)
    return init


def lecun_normal(t, g):
    std = math.sqrt(1.0 / t.shape[0]) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def glorot_uniform(t, g):
    limit = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    nn.init.uniform_(t, -limit, limit, generator=g)


def truncated_normal(stddev):
    def init(t, g):
        nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev, 2.0 * stddev, generator=g)
    return init


class Module(nn.Module):
    """nn.Module whose parameters remember their flax initialisers."""

    def __init__(self):
        super().__init__()
        self._inits = {}

    def add_param(self, name, shape, init) -> nn.Parameter:
        p = nn.Parameter(torch.empty(tuple(shape), dtype=torch.float32))
        self.register_parameter(name, p)
        self._inits[name] = init
        return p

    def share(self, name, module):
        """Holds a module owned elsewhere without registering it here, so
        that its parameters appear once in the state_dict, under the owner
        (as flax keeps shared modules)."""
        object.__setattr__(self, name, module)


@torch.no_grad()
def init_params(root: nn.Module, generator: torch.Generator):
    """Draws every parameter of ``root`` from its flax initialiser, in the
    order of ``root.modules()``."""
    for m in root.modules():
        for name, init in getattr(m, "_inits", {}).items():
            init(getattr(m, name), generator)


_KNOWN = {"elu": "elu", "sigmoid": "sigmoid", "tanh": "tanh"}


def _transfer_name(fn: Union[str, Callable, None]) -> str:
    """Kernel activation tag of a transfer ('' if the kernel has none)."""
    if fn is None:
        return "id"
    if isinstance(fn, str):
        return fn if fn in fused.ACTS else ""
    return _KNOWN.get(getattr(fn, "__name__", ""), "")


def _apply_transfer(y, fn):
    if fn is None:
        return y
    if isinstance(fn, str):
        return fused.apply_act(y, fn)
    return fn(y)


class Dense(Module):
    """flax nn.Dense: y = x kernel + bias (a plain matmul, as in the JAX
    package, where XLA runs it)."""

    def __init__(self, d_in, d_out, bias_init=zeros):
        super().__init__()
        self.add_param("kernel", (d_in, d_out), lecun_normal)
        self.add_param("bias", (d_out,), bias_init)

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(Module):
    """Elu MLP with an optional linear output head; the whole stack runs as
    one fused kernel.  A transfer the kernel does not know runs outside it:
    an unknown output transfer after the kernel, an unknown hidden transfer
    turns the whole stack into plain layers (as in the JAX package)."""

    def __init__(self, d_in: int, n_hiddens: Sequence[int], n_out: Optional[int] = None,
                 hidden_transfer="elu", transfer=None, output_bias_init=zeros):
        super().__init__()
        dims = [int(h) for h in n_hiddens] + ([n_out] if n_out is not None else [])
        self.hidden_transfer = hidden_transfer
        self.transfer = transfer
        self.has_out = n_out is not None
        self.n_layers = len(dims)
        self.d_out = dims[-1] if dims else d_in
        for i, d in enumerate(dims):
            is_out = self.has_out and i == len(dims) - 1
            self.add_param(f"w_{i}", (d_in, d), lecun_normal)
            self.add_param(f"b_{i}", (d,), output_bias_init if is_out else zeros)
            d_in = d

    def layer_params(self):
        return tuple((getattr(self, f"w_{i}"), getattr(self, f"b_{i}"))
                     for i in range(self.n_layers))

    def forward(self, x):
        params = self.layer_params()
        if not params:
            return x
        n = len(params)
        fns = [self.hidden_transfer] * n
        if self.has_out:
            fns[-1] = self.transfer
        tags = [_transfer_name(f) for f in fns]
        if any(t == "" for t in tags[:-1]):  # unknown hidden transfer
            for (w, b), fn in zip(params, fns):
                x = _apply_transfer(x @ w + b, fn)
            return x
        tail = fns[-1] if tags[-1] == "" else None
        tags[-1] = tags[-1] or "id"
        y = fused.fused_mlp(x.contiguous(), params, tags)
        return _apply_transfer(y, tail)


class Encoder(Module):
    """MLP over the (pre-flattened) last axis."""

    def __init__(self, d_in, n_hiddens):
        super().__init__()
        self.MLP_0 = MLP(d_in, n_hiddens)
        self.d_out = self.MLP_0.d_out

    def forward(self, x):
        return self.MLP_0(x)


class Decoder(Module):
    """MLP decoder reshaped to ``output_size`` and scaled by a learned scalar."""

    def __init__(self, d_in, n_hiddens, output_size, output_scale=0.25):
        super().__init__()
        self.output_size = tuple(output_size)
        self.MLP_0 = MLP(d_in, n_hiddens, n_out=math.prod(self.output_size))
        self.add_param("output_scale", (), const(output_scale))

    def forward(self, x):
        out = self.MLP_0(x)
        return out.reshape(out.shape[:-1] + self.output_size) * self.output_scale


class _Cell(Module):
    def __init__(self, units):
        super().__init__()
        self.units = units
        self.add_param("h0", (1, units), zeros)

    def initial_state(self, batch_size: int) -> State:
        return (self.h0.expand(batch_size, self.units),)

    @property
    def output_size(self):
        return self.units


class VanillaRNN(_Cell):
    """h' = tanh(x W + h U + b), one fused kernel per step."""

    def __init__(self, d_in, units):
        super().__init__(units)
        self.add_param("in_to_hidden_w", (d_in, units), lecun_normal)
        self.add_param("in_to_hidden_b", (units,), zeros)
        self.add_param("hidden_to_hidden_w", (units, units), lecun_normal)

    def forward(self, state: State, x):
        (h,) = state
        new_h = fused.fused_vanilla_rnn(x.contiguous(), h.contiguous(), self.in_to_hidden_w,
                                        self.hidden_to_hidden_w, self.in_to_hidden_b)
        return (new_h,), new_h


class GRU(_Cell):
    """Standard GRU, one fused kernel per step."""

    def __init__(self, d_in, units):
        super().__init__(units)
        self.add_param("gates_xw", (d_in, 2 * units), lecun_normal)
        self.add_param("gates_hw", (units, 2 * units), lecun_normal)
        self.add_param("gates_b", (2 * units,), zeros)
        self.add_param("candidate_xw", (d_in, units), lecun_normal)
        self.add_param("candidate_hw", (units, units), lecun_normal)
        self.add_param("candidate_b", (units,), zeros)

    def forward(self, state: State, x):
        (h,) = state
        new_h = fused.fused_gru(x.contiguous(), h.contiguous(), self.gates_xw, self.gates_hw,
                                self.gates_b, self.candidate_xw, self.candidate_hw,
                                self.candidate_b)
        return (new_h,), new_h


RNN_CELLS = {"VanillaRNN": VanillaRNN, "GRU": GRU}


def make_cell(name: str, d_in: int, units: int) -> _Cell:
    """Cell by its flag name."""
    if name not in RNN_CELLS:
        raise ValueError(f"Unknown RNN cell '{name}'. Choose from {sorted(RNN_CELLS)}")
    return RNN_CELLS[name](d_in, units)


def state_feature(state: State) -> torch.Tensor:
    """The feature half of a cell state (h)."""
    return state[-1]
