"""The MLP stack and the recurrent cells as plain tensor operations: what
the program's MLP, vanilla-RNN and GRU kernels compute, with PyTorch's
autograd for their gradients.

    mlp          act_n(... act_1(x W_1 + b_1) ... W_n + b_n)
    vanilla_rnn  h' = tanh(x W + h U + b)
    gru          zr = sigmoid(x Wg + h Ug + bg); z, r = split(zr)
                 c = tanh(x Wc + (r h) Uc + bc); h' = (1 - z) h + z c
"""
from __future__ import annotations

import torch

ACTS = ("id", "elu", "sigmoid", "tanh")


def apply_act(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "elu":
        return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "tanh":
        return torch.tanh(z)
    return z


def mlp(x, params, transfers):
    for (w, b), act in zip(params, transfers):
        x = apply_act(x @ w + b, act)
    return x


def vanilla_rnn(x, h, w, u, b):
    return torch.tanh(x @ w + h @ u + b)


def gru(x, h, wg, ug, bg, wc, uc, bc):
    zr = torch.sigmoid(x @ wg + h @ ug + bg)
    u_dim = h.shape[-1]
    z, r = zr[..., :u_dim], zr[..., u_dim:]
    c = torch.tanh(x @ wc + (r * h) @ uc + bc)
    return (1.0 - z) * h + z * c
