"""The yardstick: the card's peaks, each kernel call's operations and bytes,
the kernel calls a train step makes, and a train step's model FLOPs, all
worked out from a configuration's shapes.

``work``, ``glimpse_work``, ``prop_work``, ``disc_work``,
``main_path_shapes`` and ``expected_launches`` are frozen copies of the
program's ``chip_smoke.py`` functions of those names (the conv model chosen
by an argument in place of the flags' config path), so that a change to
the program cannot move the bounds its kernels are held to.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

# H100 SXM (NVIDIA data sheet, at its 700 W limit): HBM bytes/s, and f32
# FLOP/s off the tensor cores (the program runs its products in full f32)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

FORWARD = ("fused_mlp", "fused_vanilla_rnn", "fused_gru", "fused_glimpse", "fused_prop",
           "fused_disc")
# the kernel of a cell of each flag name (the LSTM runs in plain PyTorch)
CELL_KERNELS = {"VanillaRNN": "fused_vanilla_rnn", "GRU": "fused_gru", "LSTM": None}


def glimpse_hw(F) -> Tuple[int, int]:
    g = int(F["glimpse_size"])
    return g, g


def glimpse_shapes(F, rows, T, img):
    """The fused glimpse encoder's calls of one step, as (shape, calls):
    twice per propagation slot with the mask (when masked_glimpse), once per
    discovery slot without it."""
    h, w = 32 * int(F["n_units"]), int(F["n_what"])
    S = int(F["n_steps_per_image"])
    base = dict(n=rows, img=list(img), glimpse=list(glimpse_hw(F)), d1=h, d2=h, n_what=w)
    masked = F.get("masked_glimpse", True)
    prop = dict(base, d_mi=h if masked else 0, d_m=128 if masked else 0)
    return [(prop, 2 * S * T), (dict(base, d_mi=0, d_m=0), S * T)]


def prop_shape(F, rows, img):
    h = 32 * int(F["n_units"])
    return dict(n=rows, S=int(F["n_steps_per_image"]), img=list(img),
                glimpse=list(glimpse_hw(F)), n_what=int(F["n_what"]), U=h, SP=h // 2, WB=128,
                MH=128)


def conv_features(F, size):
    """The width of a ConvEncoder's flattened features on a side-``size``
    input: one stride-2 SAME conv a channel count of ``conv_channels``."""
    channels = [int(c) for c in str(F.get("conv_channels", "32,64")).split(",")]
    h, w = size
    for _ in channels:
        h, w = -(-h // 2), -(-w // 2)
    return h * w * channels[-1]


def coverage_on(F, conv):
    return bool(F.get("disc_coverage_signal")) and not conv


def prop_fusable(F, conv):
    return (not conv and F.get("transition", "VanillaRNN") == "VanillaRNN"
            and F.get("time_transition", "GRU") == "GRU")


def disc_fusable(F, conv):
    if conv:
        return False
    return not (float(F.get("early_disc_logit_bias", 0.0))
                or float(F.get("early_disc_logit_clamp", 0.0))
                or float(F.get("early_disc_logit_scale", 1.0)) != 1.0
                or coverage_on(F, conv) or F.get("transition", "VanillaRNN") != "VanillaRNN")


def disc_shape(F, rows, img):
    h = 32 * int(F["n_units"])
    return dict(n=rows, S=int(F["n_steps_per_image"]), img=list(img),
                glimpse=list(glimpse_hw(F)), n_what=int(F["n_what"]), U=h, SP=h // 2, C=h)


def main_path_shapes(F, B, k, T, conv, img, train=True, fuse_glimpse=False,
                     fuse_cells=False) -> List[Tuple[str, Dict, int]]:
    """Every forward kernel call of one train (or eval) step on frames of
    ``img``, as (kernel, shape, calls per step).  In the train record the
    decode, the discovery where prior and the count prior leave the time
    loop and run once over all T frames.  ``fuse_glimpse``
    (SQAIR_FUSE_GLIMPSE) moves the glimpse encoder and its mask to the fused
    glimpse kernel; ``fuse_cells`` (SQAIR_FUSE_CELLS) makes each frame's
    propagation slots one fused_prop call where the flags let it, and its
    discovery one fused_disc call where they let it.  The conv model fuses
    nothing."""
    h = 32 * int(F["n_units"])
    w, S = int(F["n_what"]), int(F["n_steps_per_image"])
    gh, gw = glimpse_hw(F)
    g = gh * gw
    rows = B * k
    slots = rows * S
    sp = h // 2
    cov = 16 if coverage_on(F, conv) else 0
    fuse_glimpse = fuse_glimpse and not conv
    deferred = T if train else 1
    per_call = T // deferred
    fuse_prop = fuse_cells and prop_fusable(F, conv)
    prop = 0 if fuse_prop else 1
    fuse_disc = fuse_cells and disc_fusable(F, conv)
    disc = 0 if fuse_disc else 1
    if conv:
        encoders = [(conv_features(F, img), [h], ["id"], rows, T),
                    (conv_features(F, (gh, gw)), [h], ["id"], rows, 3 * S * T)]
        decoder = (w, [400], ["id"], slots * deferred, per_call)
    else:
        encoders = [(img[0] * img[1], [h, h], ["elu", "elu"], rows, disc * T),
                    (g, [h, h], ["elu", "elu"], rows,
                     0 if fuse_glimpse else (disc + 2 * prop) * S * T)]
        decoder = (w, [h, h, g], ["elu", "elu", "id"], slots * deferred, per_call)
    mlp = encoders + [  # (d_in, widths, transfers, rows, calls per step)
        (h, [128, g], ["elu", "sigmoid"], rows, 0 if fuse_glimpse else 2 * prop * S * T),
        (h, [h, h, 8], ["elu", "elu", "id"], rows, disc * S * T),
        (2 * h + 4, [h, h, 8], ["elu", "elu", "id"], rows, prop * S * T),
        (h + w + cov, [sp, 1], ["elu", "id"], rows, disc * S * T),
        (2 * h + w, [sp, 1], ["elu", "id"], rows, prop * S * T),
        (h, [128, 4], ["elu", "id"], rows, prop * S * T),
        (h, [3 * w], ["sigmoid"], rows, prop * S * T),
        (w + 4, [h, h], ["elu", "elu"], slots, T),
        (1, [10, S + 1], ["elu", "id"], rows * deferred, per_call),
        decoder,
    ]
    cells = [  # (kernel, d_x, units, rows, calls per step)
        (CELL_KERNELS[F.get("transition", "VanillaRNN")], h + h + w + 5, h, rows,
         disc * S * T),
        (CELL_KERNELS[F.get("transition", "VanillaRNN")], 3 * w + 10 + h, h, rows,
         prop * S * T),
        ("fused_vanilla_rnn", 4, 4, rows * deferred, S * per_call),
        (CELL_KERNELS[F.get("prior_transition", "GRU")], w + 4, h, slots, T),
        (CELL_KERNELS[F.get("time_transition", "GRU")], h + 4 + 2 * w, h, rows,
         prop * S * T),
    ]
    out = [("fused_mlp", dict(d_in=d, widths=ws, acts=a, n=n), c) for d, ws, a, n, c in mlp
           if c]
    for kernel in ("fused_vanilla_rnn", "fused_gru"):
        out += [(kernel, dict(dx=d, units=u, n=n), c) for kn, d, u, n, c in cells
                if c and kn == kernel]
    if fuse_glimpse:
        out += [("fused_glimpse", shape, c) for shape, c in glimpse_shapes(F, rows, T, img)
                if c and not (fuse_prop if shape["d_mi"] else fuse_disc)]
    if fuse_prop:
        out += [("fused_prop", prop_shape(F, rows, img), T)]
    if fuse_disc:
        out += [("fused_disc", disc_shape(F, rows, img), T)]
    return out


def expected_launches(shapes, steps, backward=False) -> Dict[str, int]:
    """Launches of each kernel of ``shapes`` over ``steps`` steps; with
    ``backward``, also one backward launch per forward call."""
    names = [name for name in FORWARD if any(kn == name for kn, _, _ in shapes)]
    out = {name: steps * sum(c for kn, _, c in shapes if kn == name) for name in names}
    if backward:
        out.update({name + "_bwd": out[name] for name in names})
    return out


def needs_dx(kernel, shape, img):
    """False for the one call whose input carries no gradient: the MLP
    input encoder reads the frames."""
    return not (kernel == "fused_mlp" and shape["d_in"] == img[0] * img[1])


def work(kernel, shape, backward=False, need_dx=True):
    """(bytes read once and written once, f32 FLOPs) of one MLP or cell
    call, forward or backward."""
    n = shape["n"]
    if kernel == "fused_mlp":
        dims = [shape["d_in"]] + shape["widths"]
        weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        macs = n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        if not backward:
            return 4 * (n * dims[0] + weights + n * dims[-1]), 2 * macs
        acts = n * sum(dims[1:])
        w_only = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        nbytes = 4 * (n * dims[0] + w_only + acts + n * dims[-1]
                      + (n * dims[0] if need_dx else 0) + weights)
        return nbytes, 2 * (2 * macs - (0 if need_dx else n * dims[0] * dims[1]))
    dx, u = shape["dx"], shape["units"]
    mult = 1 if kernel == "fused_vanilla_rnn" else 3
    weights = mult * ((dx + u) * u + u)
    macs = n * mult * (dx + u) * u
    if not backward:
        return 4 * (n * (dx + u) + weights + n * u), 2 * macs
    saved = n * u if kernel == "fused_vanilla_rnn" else 3 * n * u
    nbytes = 4 * (n * (dx + u) + (weights - mult * u) + saved + n * u
                  + n * (dx + u) + weights)
    return nbytes, 2 * 2 * macs


def crop_macs(H, W, gh, gw, backward=False):
    """Multiply-adds of one row's bilinear crop at the two non-zeros of each
    interpolation row."""
    if not backward:
        return 2 * H * gw + 2 * gh * gw
    return 2 * H * gw + 2 * gh * gw + 2 * gh * gw + 2 * gw * H


def glimpse_work(shape, backward=False):
    """(bytes, f32 FLOPs) of one fused glimpse call."""
    n, (H, W), (gh, gw) = shape["n"], shape["img"], shape["glimpse"]
    d1, d2, nw, d_mi, d_m = (shape[k] for k in ("d1", "d2", "n_what", "d_mi", "d_m"))
    G, D = gh * gw, 2 * nw
    mats = [(d_mi, d_m), (d_m, G)] if d_mi else []
    mats += [(G, d1), (d1, d2), (d2, D)]
    weights = sum(a * b for a, b in mats)
    biases = sum(b for _, b in mats)
    mlp_macs = n * weights
    crop = n * crop_macs(H, W, gh, gw)
    inputs = n * (H * W + 4 + d_mi)
    if not backward:
        return 4 * (inputs + weights + biases + n * D), 2 * (crop + mlp_macs)
    saved = n * (G + d1 + d2 + nw + ((G + d_m) if d_mi else 0))
    nbytes = 4 * (inputs + weights + saved + n * D
                  + n * (4 + d_mi) + weights + biases)
    return nbytes, 2 * (2 * mlp_macs + n * crop_macs(H, W, gh, gw, backward=True))


def prop_work(shape, backward=False):
    """(bytes, f32 FLOPs) of one fused propagation call."""
    S, (gh, gw), nw = shape["S"], shape["glimpse"], shape["n_what"]
    U, SP, WB, MH = shape["U"], shape["SP"], shape["WB"], shape["MH"]
    n, (H, W), G = shape["n"], shape["img"], gh * gw
    d_rnn, d_stp, d_tin, d_spf = 3 * nw + 10 + U, 2 * U + 4, U + 4 + 2 * nw, 2 * U + nw
    mats = [(U, WB), (WB, 4), (U, MH), (MH, G), (G, U), (U, U), (U, 2 * nw), (G, U), (U, U),
            (U, 2 * nw), (d_rnn, U), (U, U), (d_stp, U), (U, U), (U, 8), (d_tin, 2 * U),
            (U, 2 * U), (d_tin, U), (U, U), (U, 2 * nw), (U, 3 * nw), (d_spf, SP), (SP, 1)]
    dense = sum(a * b for a, b in mats)
    crop = crop_macs(H, W, gh, gw)
    weights = (dense - (G * U + U * U + U * 2 * nw)) + 16
    biases = WB + 4 + MH + G + U + U + 2 * nw + U + U + U + 8 + 3 * U + 2 * nw + 3 * nw + SP + 1
    rows = S * n
    inputs = n * H * W + rows * (nw + 4 + 1 + U + 4 + nw + 1) + n * U
    outputs = rows * (3 * nw + 3 * 4 + 3 + U)
    R = WB + MH + G + 10 * U + 8 * nw + SP + 5  # the kernel's residual row per slot
    if not backward:
        return 4 * (inputs + weights + biases + outputs + rows * R), 2 * rows * (dense + 2 * crop)
    crop_bwd = 2 * crop_macs(H, W, gh, gw, backward=True)
    saved = rows * (2 * nw + 2 * 4 + 2 + U)
    nbytes = 4 * (inputs + weights + saved + rows * R + outputs
                  + rows * (nw + 4 + 1 + U) + n * U + weights + biases)
    return nbytes, 2 * rows * (2 * dense + crop_bwd)


def disc_work(shape, backward=False):
    """(bytes, f32 FLOPs) of one fused discovery call."""
    S, (gh, gw), nw, U, SP = shape["S"], shape["glimpse"], shape["n_what"], shape["U"], shape["SP"]
    n, (H, W), C, G = shape["n"], shape["img"], shape["C"], gh * gw
    HW, d_rnn, d_spf = H * W, U + C + nw + 5, U + nw
    enc = HW * U + U * U
    slot = (d_rnn * U + U * U + U * U + U * U + U * 8 + G * U + U * U + U * 2 * nw
            + d_spf * SP + SP)
    crop = crop_macs(H, W, gh, gw)
    weights = enc + slot
    biases = 5 * U + 8 + 2 * U + 2 * nw + SP + 1
    rows = S * n
    R = 5 * U + SP + 1
    inputs = n * (HW + C + U) + rows * (4 + nw + 1)
    outputs = rows * (3 * nw + 3 * 4 + 3)
    saved = rows * (R + G) + n * 2 * U
    if not backward:
        return (4 * (inputs + weights + biases + outputs + saved),
                2 * (n * enc + rows * (slot + crop)))
    crop_bwd = crop_macs(H, W, gh, gw, backward=True)
    nbytes = 4 * (inputs + weights + rows * (2 * nw + 2 * 4 + 2) + saved + outputs
                  + n * (C + U) + weights + biases)
    return nbytes, 2 * (2 * (n * enc + rows * slot) - n * HW * U + rows * crop_bwd)


def call_bound_s(kernel, shape, backward, img) -> float:
    """The least time one kernel call could take on the card: the larger of
    its bytes over the HBM peak and its FLOPs over the f32 peak."""
    if kernel == "fused_glimpse":
        nbytes, flops = glimpse_work(shape, backward)
    elif kernel == "fused_prop":
        nbytes, flops = prop_work(shape, backward)
    elif kernel == "fused_disc":
        nbytes, flops = disc_work(shape, backward)
    else:
        nbytes, flops = work(kernel, shape, backward, needs_dx(kernel, shape, img))
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32)


def step_bound_s(shapes, img) -> float:
    """The sum of ``call_bound_s`` over a train step's kernel calls, forward
    and backward."""
    return sum(c * (call_bound_s(kn, shape, False, img) + call_bound_s(kn, shape, True, img))
               for kn, shape, c in shapes)


# -------------------------------------------------------------- model FLOPs
def _conv_net_flops(side: Tuple[int, int], channels: Sequence[int], kernel: int) -> int:
    """FLOPs of one image through a stride-2 SAME ConvNet from one channel."""
    (h, w), c_in, total = side, 1, 0
    for c in channels:
        h, w = -(-h // 2), -(-w // 2)
        total += 2 * h * w * kernel * kernel * c_in * c
        c_in = c
    return total


def _subpixel_flops(glimpse: Tuple[int, int], kernel: int, base: int = 5, seed: int = 16,
                    hiddens: Sequence[int] = (16, 16)) -> int:
    """FLOPs of one glimpse's UpConvNet: stride-1 convs to hidden s^2
    channels, each followed by depth-to-space by s."""
    strides, rem = [], glimpse[0] // base
    while rem % 2 == 0 and rem > 1:
        strides.append(2)
        rem //= 2
    if rem > 1:
        strides.append(rem)
    while len(strides) < len(hiddens) + 1:
        strides.append(1)
    side, c_in, total = base, seed, 0
    for d, s in zip(list(hiddens) + [1], strides):
        total += 2 * side * side * kernel * kernel * c_in * d * s * s
        side, c_in = side * s, d
    return total


def model_flops(F: Mapping, conv: bool, B: int, k: int, T: int,
                img: Sequence[int]) -> Dict[str, int]:
    """The forward pass's FLOPs of one train step by kind: ``dense`` (the
    products of every MLP layer, dense layer and recurrent cell),
    ``conv`` (every convolution) and ``crops`` (each glimpse crop and each
    paste at the two pixels of each interpolation row, as the kernels'
    bounds count a crop).  Elementwise work is not counted.  A train step's
    model FLOPs are three times their sum: the backward twice the forward."""
    h, w, S = 32 * int(F["n_units"]), int(F["n_what"]), int(F["n_steps_per_image"])
    gh, gw = glimpse_hw(F)
    H, W = int(img[0]), int(img[1])
    rows, slots = B * k, B * k * S
    dense = 0
    for kernel, shape, calls in main_path_shapes(F, B, k, T, conv, (H, W)):
        if kernel == "fused_mlp":
            dims = [shape["d_in"]] + shape["widths"]
            dense += calls * 2 * shape["n"] * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        else:
            mult = 1 if kernel == "fused_vanilla_rnn" else 3
            dense += calls * 2 * shape["n"] * mult * (shape["dx"] + shape["units"]) * shape["units"]
    dense += 2 * rows * h * 2 * w * 3 * S * T         # glimpse encoders' what heads
    dense += 2 * rows * h * 2 * w * S * T             # propagation's temporal what head
    dense += 2 * rows * T * ((4 + h + 1) * 128 + 128 * 4 + S * 4 * 8)  # discovery where prior
    dense += 2 * slots * T * h * (2 * (4 + w) + 1)    # propagation prior readout
    conv_flops = 0
    if conv:
        channels = [int(c) for c in str(F["conv_channels"]).split(",")]
        kernel = int(F["conv_kernel"])
        conv_flops += rows * T * _conv_net_flops((H, W), channels, kernel)
        conv_flops += rows * 3 * S * T * _conv_net_flops((gh, gw), channels, kernel)
        conv_flops += slots * T * _subpixel_flops((gh, gw), kernel)
    crop = 2 * crop_macs(H, W, gh, gw)
    paste = 2 * (2 * gh * W + 2 * H * W)
    crops = rows * 3 * S * T * crop + slots * T * paste
    return dict(dense=dense, conv=conv_flops, crops=crops)


def train_step_flops(F: Mapping, conv: bool, B: int, k: int, T: int, img) -> int:
    """A train step's model FLOPs: three times the forward's."""
    return 3 * sum(model_flops(F, conv, B, k, T, img).values())
