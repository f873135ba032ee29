"""Fused MLP and recurrent-cell forward kernels, with their plain versions.

Each function here computes what a Pallas TPU kernel of
``sqair_tpu/ops/fused.py`` computes:

  fused_mlp          act_n(... act_1(x W_1 + b_1) ... W_n + b_n)
  fused_vanilla_rnn  h' = tanh(x W + h U + b)
  fused_gru          zr = sigmoid(x Wg + h Ug + bg); z, r = split(zr)
                     c = tanh(x Wc + (r h) Uc + bc); h' = (1 - z) h + z c

On a CUDA tensor the wrapper launches the hand-written kernel of
``sqair_tpu_torch/csrc`` (built by ``ops/build.py``) or raises; on a CPU
tensor it runs the plain PyTorch version beside it.  ``launches`` counts the
kernel launches of each wrapper.  Only the forward kernels exist yet: a
call that would need a gradient raises on CUDA.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Sequence, Tuple

import torch

ACTS = ("id", "elu", "sigmoid", "tanh")
MAX_LAYERS = 4  # csrc/fused_mlp.cu kMaxLayers
MAX_WIDTH = 1024  # csrc/common.cuh kMaxWidth

launches = collections.Counter()


def reset_launches():
    launches.clear()


def apply_act(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "elu":
        # the JAX package's form (ops/fused.py _apply_act)
        return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "tanh":
        return torch.tanh(z)
    return z


# ------------------------------------------------------------ plain versions
def mlp_plain(x, params, transfers):
    for (w, b), act in zip(params, transfers):
        x = apply_act(x @ w + b, act)
    return x


def vanilla_rnn_plain(x, h, w, u, b):
    return torch.tanh(x @ w + h @ u + b)


def gru_plain(x, h, wg, ug, bg, wc, uc, bc):
    zr = torch.sigmoid(x @ wg + h @ ug + bg)
    u_dim = h.shape[-1]
    z, r = zr[..., :u_dim], zr[..., u_dim:]
    c = torch.tanh(x @ wc + (r * h) @ uc + bc)
    return (1.0 - z) * h + z * c


# ------------------------------------------------------------------ checks
def _check(name, tensors, device):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: backward kernel lands with the training slice "
            "(run the forward under torch.inference_mode())")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _on_cuda(name, x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(name, code):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


# ---------------------------------------------------------------- wrappers
def fused_mlp(x: torch.Tensor, params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              transfers: Sequence[str]) -> torch.Tensor:
    """Runs an MLP stack as one kernel.

    :param x: [..., d_in] (leading dims are flattened for the kernel)
    :param params: ((W [d_i, d_{i+1}], b [d_{i+1}]), ...)
    :param transfers: activation per layer, from ``ACTS``
    """
    transfers = tuple(transfers)
    if len(transfers) != len(params):
        raise ValueError("one transfer per layer")
    for t in transfers:
        if t not in ACTS:
            raise ValueError(f"unknown transfer '{t}'")
    if not _on_cuda("fused_mlp", x):
        return mlp_plain(x, params, transfers)

    from .build import library

    n_layers = len(params)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"fused_mlp: 1 to {MAX_LAYERS} layers, got {n_layers}")
    dims = [x.shape[-1]]
    for w, b in params:
        if w.ndim != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"fused_mlp: layer shapes {tuple(w.shape)}, "
                             f"{tuple(b.shape)} after width {dims[-1]}")
        if w.shape[1] > MAX_WIDTH:
            raise ValueError(f"fused_mlp: width {w.shape[1]} > {MAX_WIDTH}")
        dims.append(w.shape[1])
    lead = x.shape[:-1]
    x2 = x.reshape(-1, dims[0])
    flat = [t for wb in params for t in wb]
    _check("fused_mlp", [x2, *flat], x.device)
    n = x2.shape[0]
    y = torch.empty((n, dims[-1]), dtype=torch.float32, device=x.device)
    if n == 0:
        return y.reshape(*lead, dims[-1])
    c_dims = (ctypes.c_int * (n_layers + 1))(*dims)
    c_acts = (ctypes.c_int * n_layers)(*[ACTS.index(t) for t in transfers])
    c_w = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w, _ in params])
    c_b = (ctypes.c_void_p * n_layers)(*[b.data_ptr() for _, b in params])
    code = library().sqair_fused_mlp(
        _ptr(x2), _ptr(y), n, n_layers, ctypes.cast(c_dims, ctypes.c_void_p),
        ctypes.cast(c_acts, ctypes.c_void_p), ctypes.cast(c_w, ctypes.c_void_p),
        ctypes.cast(c_b, ctypes.c_void_p), None, _stream(x.device))
    _raise_on("fused_mlp", code)
    launches["fused_mlp"] += 1
    return y.reshape(*lead, dims[-1])


def _check_cell(name, x, h, mats):
    if x.ndim != 2 or h.ndim != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and h {tuple(h.shape)}")
    for t, shape in mats:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")


def fused_vanilla_rnn(x, h, w, u, b):
    """h' = tanh(x W + h U + b) as one kernel.  x [N, d_x], h [N, U]."""
    if not _on_cuda("fused_vanilla_rnn", x):
        return vanilla_rnn_plain(x, h, w, u, b)

    from .build import library

    n, dx = x.shape
    units = h.shape[-1]
    _check_cell("fused_vanilla_rnn", x, h,
                [(w, (dx, units)), (u, (units, units)), (b, (units,))])
    if units > MAX_WIDTH:
        raise ValueError(f"fused_vanilla_rnn: {units} units > {MAX_WIDTH}")
    _check("fused_vanilla_rnn", [x, h, w, u, b], x.device)
    hn = torch.empty((n, units), dtype=torch.float32, device=x.device)
    if n == 0:
        return hn
    code = library().sqair_fused_vanilla_rnn(
        _ptr(x), _ptr(h), _ptr(w), _ptr(u), _ptr(b), _ptr(hn), n, dx, units,
        _stream(x.device))
    _raise_on("fused_vanilla_rnn", code)
    launches["fused_vanilla_rnn"] += 1
    return hn


def fused_gru(x, h, wg, ug, bg, wc, uc, bc):
    """One GRU step as one kernel.  x [N, d_x], h [N, U]."""
    if not _on_cuda("fused_gru", x):
        return gru_plain(x, h, wg, ug, bg, wc, uc, bc)

    from .build import library

    n, dx = x.shape
    units = h.shape[-1]
    _check_cell("fused_gru", x, h,
                [(wg, (dx, 2 * units)), (ug, (units, 2 * units)),
                 (bg, (2 * units,)), (wc, (dx, units)), (uc, (units, units)),
                 (bc, (units,))])
    if 2 * units > MAX_WIDTH:
        raise ValueError(f"fused_gru: {units} units > {MAX_WIDTH // 2}")
    _check("fused_gru", [x, h, wg, ug, bg, wc, uc, bc], x.device)
    hn = torch.empty((n, units), dtype=torch.float32, device=x.device)
    if n == 0:
        return hn
    code = library().sqair_fused_gru(
        _ptr(x), _ptr(h), _ptr(wg), _ptr(ug), _ptr(bg), _ptr(wc), _ptr(uc),
        _ptr(bc), _ptr(hn), None, None, n, dx, units, _stream(x.device))
    _raise_on("fused_gru", code)
    launches["fused_gru"] += 1
    return hn
