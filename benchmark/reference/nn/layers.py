"""NN primitives: MLP, conv layers and recurrent cells, in plain PyTorch
(a frozen copy of the program's ``nn/layers.py`` with the plain versions in
place of its kernels).

Parameters keep the program's names and layouts (MLP weights ``w_i``
[d_in, d_out], ``b_i``; cells ``in_to_hidden_w``, ``gates_xw``, ...), so
that the benchmark loads the same named weights into both.  Cells follow
the interface ``cell(state, x) -> (new_state, output)`` with ``state`` a
tuple: ``(h,)`` for VanillaRNN and GRU, ``(c, h)`` for the LSTM.

The conv modules take and give NHWC tensors.  A conv kernel is stored HWIO
[kh, kw, c_in, c_out] and permuted to OIHW at the call (``conv2d_same``);
SAME padding is asymmetric at stride 2 (50 -> 25 pads (0, 1)), so the
padding is computed from its rule and applied explicitly.

Each parameter records its initialiser (``Module._inits``): the benchmark's
weight maker reads the kind and scale of each from there.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dense

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
    # fan-in: every axis but the output's (a Dense kernel's d_in, a conv
    # kernel's kh kw c_in), as flax's variance_scaling counts it
    std = math.sqrt(1.0 / math.prod(t.shape[:-1])) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def glorot_uniform(t, g):
    limit = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    nn.init.uniform_(t, -limit, limit, generator=g)


def truncated_normal(stddev):
    def init(t, g):
        nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev, 2.0 * stddev, generator=g)
    init.stddev = stddev
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
        return fn if fn in dense.ACTS else ""
    return _KNOWN.get(getattr(fn, "__name__", ""), "")


def _apply_transfer(y, fn):
    if fn is None:
        return y
    if isinstance(fn, str):
        return dense.apply_act(y, fn)
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
    plain layers.  An output transfer that ``dense.ACTS`` does not name runs
    after the stack; an unknown hidden transfer runs the layers one by one."""

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
        y = dense.mlp(x, params, tags)
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


def _per_layer(param, n: int) -> int:
    """A per-layer setting: the n-th of a sequence, or the one value."""
    if isinstance(param, (list, tuple)):
        return int(param[n] if len(param) > 1 else param[0])
    return int(param)


def same_padding(size: int, kernel: int, stride: int, dilation: int = 1):
    """flax's SAME padding of one axis: (low, high), the odd pixel high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x, kernel, bias, stride=1, dilation=1):
    """flax ``nn.Conv`` with SAME padding on NHWC ``x`` [N, H, W, C] and an
    HWIO ``kernel`` [kh, kw, C, C_out]: [N, H', W', C_out]."""
    kh, kw = kernel.shape[:2]
    (t, b), (l, r) = (same_padding(x.shape[1], kh, stride, dilation),
                      same_padding(x.shape[2], kw, stride, dilation))
    xc = x.permute(0, 3, 1, 2)  # NCHW, channels-last in memory
    if (t, l) == (b, r):
        pad = (t, l)
    else:
        xc, pad = F.pad(xc, (l, r, t, b)), 0
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), bias, stride=stride, padding=pad,
                 dilation=dilation)
    return y.permute(0, 2, 3, 1)


class Conv(Module):
    """flax nn.Conv (SAME): ``kernel`` HWIO [k, k, c_in, c_out], ``bias``."""

    def __init__(self, c_in, c_out, kernel_shape, stride=1, dilation=1):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.add_param("kernel", (kernel_shape, kernel_shape, c_in, c_out), lecun_normal)
        self.add_param("bias", (c_out,), zeros)

    def forward(self, x):
        return conv2d_same(x, self.kernel, self.bias, self.stride, self.dilation)


def _depth_to_space(x, block: int):
    """[..., H, W, b b c] -> [..., H b, W b, c], the channels read as
    (b1, b2, c) with c innermost (the JAX package's layout, not
    ``F.pixel_shuffle``'s (c, b1, b2))."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    c_out = C // (block * block)
    x = x.reshape(lead + (H, W, block, block, c_out)).transpose(-4, -3)
    return x.reshape(lead + (H * block, W * block, c_out))


class ConvNet(Module):
    """Elu ConvNet with an optional linear conv output head; ``stride`` and
    ``rate`` (dilation) are one value or one per layer.  NHWC."""

    def __init__(self, c_in, kernel_shape, n_hiddens, n_out=None, hidden_transfer=F.elu,
                 transfer=None, stride=1, rate=1):
        super().__init__()
        self.hidden_transfer, self.transfer = hidden_transfer, transfer
        dims = [int(h) for h in n_hiddens] + ([n_out] if n_out is not None else [])
        self.n_convs, self.has_out = len(dims), n_out is not None
        for n, d in enumerate(dims):
            setattr(self, f"Conv_{n}", Conv(c_in, d, kernel_shape, _per_layer(stride, n),
                                            _per_layer(rate, n)))
            c_in = d
        self.c_out = c_in

    def out_size(self, size: int) -> int:
        """The output side of an input side ``size`` (SAME: ceil(size / s))."""
        for n in range(self.n_convs):
            size = -(-size // getattr(self, f"Conv_{n}").stride)
        return size

    def forward(self, x):
        """:param x: [N, H, W, C]"""
        for n in range(self.n_convs):
            x = getattr(self, f"Conv_{n}")(x)
            is_out = self.has_out and n == self.n_convs - 1
            fn = self.transfer if is_out else self.hidden_transfer
            if fn is not None:
                x = fn(x)
        return x


class UpConvNet(Module):
    """Subpixel upsampler: each layer a stride-1 conv to ``n_hidden s^2``
    channels, then depth-to-space by its stride s.  NHWC."""

    def __init__(self, c_in, kernel_shape, n_hiddens, n_out=None, hidden_transfer=F.elu,
                 transfer=None, stride=1):
        super().__init__()
        self.hidden_transfer, self.transfer = hidden_transfer, transfer
        dims = [int(h) for h in n_hiddens] + ([n_out] if n_out is not None else [])
        self.n_convs, self.has_out = len(dims), n_out is not None
        self.strides = [_per_layer(stride, n) for n in range(len(dims))]
        for n, (d, s) in enumerate(zip(dims, self.strides)):
            setattr(self, f"Conv_{n}", Conv(c_in, d * s * s, kernel_shape))
            c_in = d

    def forward(self, x):
        for n, s in enumerate(self.strides):
            x = getattr(self, f"Conv_{n}")(x)
            if s > 1:
                x = _depth_to_space(x, s)
            is_out = self.has_out and n == self.n_convs - 1
            fn = self.transfer if is_out else self.hidden_transfer
            if fn is not None:
                x = fn(x)
        return x


class ConvEncoder(Module):
    """Conv feature extractor over flattened images or glimpses [..., h w]
    (in the place of ``Encoder``): a stride-2 ConvNet, a flatten in
    (h, w, c) order and a one-layer MLP (``MLP_0``, linear: one dense
    call) to ``n_features``, then elu."""

    def __init__(self, img_size, n_hiddens, n_features=256, kernel_shape=3, stride=2):
        super().__init__()
        self.img_size = tuple(int(s) for s in img_size)
        self.ConvNet_0 = ConvNet(1, kernel_shape, n_hiddens, stride=stride)
        h, w = (self.ConvNet_0.out_size(s) for s in self.img_size)
        self.MLP_0 = MLP(h * w * self.ConvNet_0.c_out, [], n_out=n_features)
        self.d_out = n_features

    def forward(self, x):
        h, w = self.img_size
        lead = x.shape[:-1]
        feats = self.ConvNet_0(x.reshape(-1, h, w, 1))
        out = F.elu(self.MLP_0(feats.reshape(feats.shape[0], -1)))
        return out.reshape(lead + (self.d_out,))


class SubpixelDecoder(Module):
    """UpConvNet glimpse decoder (in the place of ``Decoder``): a linear
    one-layer MLP (``MLP_0``) to a base_size x base_size x 16 seed map, elu,
    then an UpConvNet whose strides factor the upsampling to the glimpse
    (stride-2 layers first), one output channel, scaled by a learned
    scalar."""

    SEED_CHANNELS = 16

    def __init__(self, d_in, n_hiddens, output_size, output_scale=0.25, base_size=5,
                 kernel_shape=3):
        super().__init__()
        gh, gw = self.output_size = tuple(int(s) for s in output_size)
        if gh % base_size or gw % base_size:
            raise ValueError("glimpse size must be a multiple of base_size")
        self.base_size = base_size
        strides, rem = [], gh // base_size
        while rem % 2 == 0 and rem > 1:
            strides.append(2)
            rem //= 2
        if rem > 1:
            strides.append(rem)
        hiddens = [int(h) for h in n_hiddens]
        while len(strides) < len(hiddens) + 1:
            strides.append(1)
        c = self.SEED_CHANNELS
        self.MLP_0 = MLP(d_in, [], n_out=base_size * base_size * c)
        self.UpConvNet_0 = UpConvNet(c, kernel_shape, hiddens, n_out=1, stride=strides)
        self.add_param("output_scale", (), const(output_scale))

    def forward(self, x):
        lead, b = x.shape[:-1], self.base_size
        seed = F.elu(self.MLP_0(x)).reshape(-1, b, b, self.SEED_CHANNELS)
        out = self.UpConvNet_0(seed)
        return out[..., 0].reshape(lead + self.output_size) * self.output_scale


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
    """h' = tanh(x W + h U + b), plain."""

    def __init__(self, d_in, units):
        super().__init__(units)
        self.add_param("in_to_hidden_w", (d_in, units), lecun_normal)
        self.add_param("in_to_hidden_b", (units,), zeros)
        self.add_param("hidden_to_hidden_w", (units, units), lecun_normal)

    def forward(self, state: State, x):
        (h,) = state
        new_h = dense.vanilla_rnn(x, h, self.in_to_hidden_w, self.hidden_to_hidden_w,
                                  self.in_to_hidden_b)
        return (new_h,), new_h


class GRU(_Cell):
    """Standard GRU, plain."""

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
        new_h = dense.gru(x, h, self.gates_xw, self.gates_hw, self.gates_b,
                          self.candidate_xw, self.candidate_hw, self.candidate_b)
        return (new_h,), new_h


class LSTM(_Cell):
    """Standard LSTM with state (c, h): one Dense ``ifgo`` over [x, h], the
    forget gate's logit + 1, trainable ``c0`` and ``h0``.  Plain PyTorch,
    as the JAX package runs it in XLA (no kernel)."""

    def __init__(self, d_in, units):
        super().__init__(units)
        self.add_param("c0", (1, units), zeros)
        self.ifgo = Dense(d_in + units, 4 * units)

    def initial_state(self, batch_size: int) -> State:
        return (self.c0.expand(batch_size, self.units), self.h0.expand(batch_size, self.units))

    def forward(self, state: State, x):
        c, h = state
        i, f, g, o = torch.chunk(self.ifgo(torch.cat([x, h], -1)), 4, -1)
        new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


RNN_CELLS = {"VanillaRNN": VanillaRNN, "GRU": GRU, "LSTM": LSTM}


def make_cell(name: str, d_in: int, units: int) -> _Cell:
    """Cell by its flag name."""
    if name not in RNN_CELLS:
        raise ValueError(f"Unknown RNN cell '{name}'. Choose from {sorted(RNN_CELLS)}")
    return RNN_CELLS[name](d_in, units)


def state_feature(state: State) -> torch.Tensor:
    """The feature half of a cell state: h (the LSTM's second tensor)."""
    return state[-1]
