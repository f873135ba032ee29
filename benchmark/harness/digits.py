"""The training data of a run: moving-digit sequences rendered on the card
from the seed (a frozen copy of the program's ``make_template_bank``,
``noisy_acceleration`` and ``OnDeviceSeqMNIST``).

A bank of stroke-digit templates is drawn on the host with numpy; each
sequence's object count, templates, first positions and trajectory draws
come from one ``torch.Generator`` on the card; the frames are the max over
the objects of a bilinear paste of each template along its trajectory,
stored as uint8.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from reference.ops import stn


def _stamp(canvas: np.ndarray, y: float, x: float, intensity: float, radius: float):
    h, w = canvas.shape
    yy, xx = np.mgrid[0:h, 0:w]
    canvas += intensity * np.exp(-(((yy - y) ** 2 + (xx - x) ** 2) / (2 * radius**2)))


def make_stroke_template(rng: np.random.RandomState, size: int = 28) -> np.ndarray:
    """One digit-like template: 1-3 smooth quadratic strokes."""
    canvas = np.zeros((size, size), np.float32)
    for _ in range(rng.randint(1, 4)):
        pts = rng.uniform(size * 0.15, size * 0.85, size=(3, 2))
        for t in np.linspace(0.0, 1.0, 24):
            p = (1 - t) ** 2 * pts[0] + 2 * (1 - t) * t * pts[1] + t**2 * pts[2]
            _stamp(canvas, p[0], p[1], 1.0, rng.uniform(1.0, 1.6))
    canvas = np.clip(canvas / max(canvas.max(), 1e-6), 0.0, 1.0)
    canvas = np.clip(canvas * 1.8 - 0.15, 0.0, 1.0)
    return (canvas * 255).astype(np.uint8)


def make_template_bank(n: int, size: int = 28, seed: int = 0) -> np.ndarray:
    """[n, size, size] uint8 bank of stroke-digit templates."""
    rng = np.random.RandomState(seed)
    return np.stack([make_stroke_template(rng, size) for _ in range(n)])


def noisy_acceleration(init_pos, vel, acc, noise, pos_bounds, max_speed, max_acc,
                       noise_std=0.01) -> torch.Tensor:
    """[T, N, 2] positions: (pos, vel, acc) dynamics with acceleration
    noise, elastic bounces off ``pos_bounds`` and clamps."""
    bounds = torch.tensor(pos_bounds, dtype=torch.float32, device=init_pos.device)
    lo, hi = bounds[:, 0], bounds[:, 1]
    pos, out = init_pos, [init_pos]
    for eps in noise:
        pos = pos + vel
        vel = vel + acc
        acc = acc + noise_std * eps
        too_small, too_big = pos < lo, pos > hi
        pos = torch.where(too_small, 2 * lo - pos, pos)
        pos = torch.where(too_big, 2 * hi - pos, pos)
        flip = too_small | too_big
        vel = torch.where(flip, -vel, vel)
        acc = torch.where(flip, -acc, acc)
        pos = torch.minimum(torch.maximum(pos, lo), hi)
        vel = torch.clamp(vel, -max_speed, max_speed)
        acc = torch.clamp(acc, -max_acc, max_acc)
        out.append(pos)
    return torch.stack(out, 0)


def render(templates: torch.Tensor, generator: torch.Generator, batch: int, frames: int,
           canvas: Tuple[int, int], objects: Tuple[int, int], max_speed: float = 10.0,
           max_acc: float = 3.0) -> Dict[str, torch.Tensor]:
    """One batch of sequences on the generator's device.

    :param templates: [N, th, tw] float32 in [0, 1] on the device
    :return: dict(imgs [T, B, H, W] float32 in [0, 1], nums [T, B, M + 1]
        cumulative one-hot object counts)
    """
    device = generator.device
    (H, W), (th, tw) = canvas, templates.shape[1:3]
    lo, hi = objects
    B, M, T = batch, max(hi, 1), frames
    nums = torch.randint(lo, hi + 1, (B,), generator=generator, device=device)
    idx = torch.randint(0, templates.shape[0], (B, M), generator=generator, device=device)
    span = torch.tensor([H - th, W - tw], dtype=torch.float32, device=device)
    init_pos = torch.rand((B * M, 2), generator=generator, device=device) * span

    def uniform(bound):
        return (2.0 * torch.rand((B * M, 2), generator=generator, device=device) - 1.0) * bound

    vel, acc = uniform(max_speed), uniform(max_acc)
    noise = torch.randn((T - 1, B * M, 2), generator=generator, device=device)
    tjs = noisy_acceleration(init_pos, vel, acc, noise, [[0.0, float(H - th)], [0.0, float(W - tw)]],
                             max_speed, max_acc).reshape(T, B, M, 2)
    obj_mask = (torch.arange(M, device=device)[None] < nums[:, None]).to(torch.float32)
    size = torch.tensor([float(th), float(tw)], device=device)
    boxes = torch.cat([tjs, size.expand(T, B, M, 2)], -1)
    coords = stn.pixel_to_stn_coords(boxes, (H, W))
    pasted = stn.paste_glimpse(templates[idx][None].expand(T, B, M, th, tw), coords, (H, W))
    imgs = torch.amax(pasted * obj_mask[None, :, :, None, None], 2)
    counts = (torch.arange(M + 1, device=device)[None] < nums[:, None]).to(torch.float32)
    return dict(imgs=imgs, nums=counts[None].expand(T, B, M + 1))


def make_dataset(spec: Dict, seed: int, generator: torch.Generator,
                 chunk: int = 2048) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """The traffic's data set on the generator's device, imgs [T, N, H, W]
    uint8 and nums [T, N, M + 1] float32, rendered ``chunk`` sequences at a
    time from a template bank drawn from ``seed``; and its mean frame
    (host float32 [H, W], in [0, 1])."""
    bank = make_template_bank(int(spec["templates"]), int(spec["template_size"]),
                              seed % 2**32)
    device = generator.device
    templates = torch.from_numpy(bank.astype(np.float32)).to(device) / 255.0
    n, T = int(spec["sequences"]), int(spec["frames"])
    canvas, objects = tuple(spec["canvas"]), tuple(spec["objects"])
    imgs = torch.empty((T, n, canvas[0], canvas[1]), dtype=torch.uint8, device=device)
    nums = torch.empty((T, n, max(objects[1], 1) + 1), dtype=torch.float32, device=device)
    total = torch.zeros(canvas, dtype=torch.float64, device=device)
    for at in range(0, n, chunk):
        b = min(chunk, n - at)
        out = render(templates, generator, b, T, canvas, objects)
        frames = torch.round(out["imgs"] * 255.0)
        imgs[:, at:at + b] = frames.to(torch.uint8)
        nums[:, at:at + b] = out["nums"]
        total += frames.sum((0, 1), dtype=torch.float64)
    mean = (total / (255.0 * T * n)).to(torch.float32)
    return dict(imgs=imgs, nums=nums), mean.cpu().numpy()
