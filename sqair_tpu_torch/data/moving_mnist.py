"""Moving-multi-digit sequence data (the port of
sqair_tpu/data/moving_mnist.py): static canvases, trajectories seeded at
the static positions and max-composited rendering (numpy, a copy of the
JAX package's host path); a device-resident minibatch sampler; and
``OnDeviceSeqMNIST``, which renders whole batches on the device."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import stn
from .synthetic import make_template_bank, template_dimensions
from .trajectory import NoisyAccelerationTrajectory, draw_noisy_acceleration, noisy_acceleration


def create_static(templates: np.ndarray, labels: Optional[np.ndarray] = None,
                  canvas_size=(50, 50), n_objects=(0, 2), n_samples=1000,
                  seed=0) -> Dict:
    """Static multi-digit canvases with non-overlap rejection sampling.

    Mirror of create_mnist (reference data.py:64-186), tight-bbox template
    extraction included.  Always records coords and trimmed templates.
    """
    rng = np.random.RandomState(seed)
    n_templates = len(templates)
    if labels is None:
        labels_bank = np.zeros((n_templates,), np.uint8)
    else:
        labels_bank = labels

    min_obj, max_obj = sorted(n_objects)
    imgs = np.zeros((n_samples,) + tuple(canvas_size), np.uint8)
    out_labels = np.zeros((n_samples, max_obj), np.uint8)
    nums = rng.randint(min_obj, max_obj + 1, size=n_samples).astype(np.uint8)

    used_templates = [[] for _ in range(n_samples)]
    used_coords = [[] for _ in range(n_samples)]

    i, n_tries = 0, 5
    while i < n_samples:
        tries, retry = 0, False
        n = nums[i]
        used_templates[i], used_coords[i] = [], []
        occupancy = np.zeros(canvas_size, bool)
        if n > 0:
            indices = rng.choice(n_templates, n, replace=False)
            for j in range(n):
                idx = indices[j]
                out_labels[i, j] = labels_bank[idx]
                template = templates[idx]
                st, size = template_dimensions(template)
                template = template[st[0]:st[0] + size[0], st[1]:st[1] + size[1]]

                def make_coord():
                    pos = rng.rand(2) * (np.asarray(canvas_size) - size)
                    coord = np.round(pos).astype(np.int32)
                    return coord

                pos = make_coord()
                while (occupancy[pos[0]:pos[0] + size[0], pos[1]:pos[1] + size[1]].any()
                       and tries < n_tries):
                    pos = make_coord()
                    tries += 1
                if tries == n_tries:
                    retry = True
                    break

                used_templates[i].append(template)
                used_coords[i].append(pos)
                imgs[i, pos[0]:pos[0] + size[0], pos[1]:pos[1] + size[1]] = template
                occupancy[pos[0]:pos[0] + size[0], pos[1]:pos[1] + size[1]] = True

        if not retry:
            i += 1
        else:
            imgs[i, ...] = 0

    # cumulative one-hot counts [max+1, N, 1] (data.py:172-177)
    expanded = np.zeros((max_obj + 1, n_samples, 1), np.uint8)
    for i, n in enumerate(nums):
        expanded[:n, i] = 1

    return dict(imgs=imgs, labels=out_labels, nums=expanded,
                coords=used_coords, templates=used_templates)


def render_sequences(coords, templates, canvas_size, n_timesteps) -> np.ndarray:
    """Max-composite template blending (reference template.py:45-104)."""
    n_samples = len(templates)
    canvas = np.zeros((n_timesteps, n_samples) + tuple(canvas_size), np.float32)
    H, W = canvas_size

    for i, (tjs, seq_templates) in enumerate(zip(coords, templates)):
        for tj, template in zip(tjs, seq_templates):
            th, tw = template.shape[:2]
            for t in range(len(tj)):
                y0, x0 = (int(v) for v in np.round(tj[t]))
                y1, x1 = y0 + th, x0 + tw
                ys0, ys1 = max(-y0, 0), th - max(y1 - H, 0)
                xs0, xs1 = max(-x0, 0), tw - max(x1 - W, 0)
                yd0, yd1 = max(y0, 0), min(y1, H)
                xd0, xd1 = max(x0, 0), min(x1, W)
                if yd1 <= yd0 or xd1 <= xd0:
                    continue
                region = canvas[t, i, yd0:yd1, xd0:xd1]
                canvas[t, i, yd0:yd1, xd0:xd1] = np.maximum(
                    region, template[ys0:ys1, xs0:xs1]
                )

    m = canvas.max()
    if m > 0:
        canvas = canvas / (m / 255.0)
    return canvas.astype(np.uint8)


def create_seq_dataset(n_samples=1000, n_timesteps=10, canvas_size=(50, 50),
                       obj_size=(28, 28), n_objects=(0, 2), seed=0,
                       templates: Optional[np.ndarray] = None,
                       labels: Optional[np.ndarray] = None) -> Dict:
    """Full mirror of create_seq_mnist.py: static -> trajectories -> render.

    :param labels: optional per-template class labels (real-MNIST path)
    :return: dict(imgs [T,N,H,W] uint8, labels, nums [1,N,max+1] uint8,
        coords [T,N,max,4] float)
    """
    if templates is None:
        templates = make_template_bank(max(256, n_samples // 4), obj_size[0], seed)

    data = create_static(templates, labels=labels, canvas_size=canvas_size,
                         n_objects=n_objects, n_samples=n_samples, seed=seed)

    # trajectories seeded at the static coords (create_seq_mnist.py:35-62)
    flat_coords = [c for sample in data["coords"] for c in sample]
    trajectory = NoisyAccelerationTrajectory(
        noise_std=0.01, n_dim=2,
        pos_bounds=[[0, canvas_size[0] - obj_size[0]], [0, canvas_size[1] - obj_size[1]]],
        max_speed=10, max_acc=3, bounce=True,
    )
    if flat_coords:
        tjs_flat = trajectory.create(n_timesteps, len(flat_coords),
                                     init_from=np.asarray(flat_coords), seed=seed)
    else:
        tjs_flat = np.zeros((n_timesteps, 0, 2), np.float32)

    # unflatten back per sample
    tjs, k = [], 0
    for sample in data["coords"]:
        tjs.append([tjs_flat[:, k + j] for j in range(len(sample))])
        k += len(sample)

    img_seq = render_sequences(tjs, data["templates"], canvas_size, n_timesteps)

    # pack coords [T, N, max, 4] = (y, x, h, w)  (create_seq_mnist.py:65-87)
    nums = data["nums"].T  # [1, N, max+1]
    counts = nums.astype(np.int32).sum(-1)  # [1, N]
    n_max = max(int(counts.max()), 1)
    coords = np.zeros((n_timesteps, n_samples, n_max, 4), np.float32)
    for i in range(n_samples):
        for num in range(counts[0, i]):
            coords[:, i, num, :2] = tjs[i][num]
            coords[:, i, num, 2:] = data["templates"][i][num].shape

    return dict(imgs=img_seq, labels=data["labels"], nums=nums, coords=coords)


class DeviceDatasetSampler:
    """The whole dataset on the model's device, and a minibatch gather from
    it per step (the counterpart of the JAX package's
    OnDeviceDatasetSampler): no host round trip, no per-step rendering.

    The frames stay on the device sample-major ([N, T, H, W]) in the type
    they come in: uint8 frames (the generator's) are scaled to [0, 1] on
    the device at each gather; float32 frames (a data config's data_dict,
    already in [0, 1]) are gathered as they are, so that a batch holds the
    very values of the host path's batches.  A batch is gathered with
    indices drawn from an explicit ``torch.Generator``.

    :param data: imgs [T, N, H, W] uint8 or float32, nums [T or 1, N, C]:
        numpy arrays, or tensors (e.g. ``OnDeviceSeqMNIST``'s output on the
        device, which stays there)
    """

    def __init__(self, data: Dict, device):
        self.device = torch.device(device)
        imgs, nums = (torch.as_tensor(data[key]) for key in ("imgs", "nums"))
        if imgs.dtype not in (torch.uint8, torch.float32):
            raise TypeError(f"expected uint8 or float32 frames, got {imgs.dtype}")
        nums = nums.to(torch.float32)
        if nums.shape[0] == 1:  # [1, N, C]: the same counts in every frame
            nums = nums.expand((imgs.shape[0],) + tuple(nums.shape[1:]))
        self.imgs = imgs.to(self.device).transpose(0, 1).contiguous()
        self.nums = nums.to(self.device).transpose(0, 1).contiguous()
        self.n = self.imgs.shape[0]

    def sample(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        """:return: dict(imgs [T, B, H, W] float32 in [0, 1], nums [T, B, C])"""
        idx = torch.randint(0, self.n, (batch_size,), generator=generator,
                            device=self.device)
        imgs = self.imgs.index_select(0, idx)
        if imgs.dtype == torch.uint8:
            imgs = imgs.to(torch.float32) / 255.0
        nums = self.nums.index_select(0, idx)
        return dict(imgs=imgs.transpose(0, 1).contiguous(),
                    nums=nums.transpose(0, 1).contiguous())


class OnDeviceSeqMNIST:
    """Moving-digit batches rendered on the device (the port of the JAX
    package's ``OnDeviceSeqMNIST``).

    The template bank lives on the device.  A call draws the object counts,
    each object's template and first position and its trajectory's draws
    from an explicit ``torch.Generator`` (``draw``), then renders the batch
    from those draws (``render``): the trajectories, a bilinear paste of
    each template at its positions, the max over the objects, the
    cumulative one-hot counts and the boxes.  ``render`` holds all the
    arithmetic, so that draws made elsewhere render the same way.
    """

    def __init__(self, templates: np.ndarray, canvas_size=(50, 50), n_timesteps: int = 10,
                 n_objects=(0, 2), max_speed: float = 10.0, max_acc: float = 3.0,
                 noise_std: float = 0.01, device="cuda"):
        self.device = resolve_device(device)
        self.templates = torch.from_numpy(np.asarray(templates, np.float32)).to(
            self.device) / 255.0  # [N, th, tw]
        self.canvas_size = tuple(int(v) for v in canvas_size)
        self.n_timesteps = n_timesteps
        self.min_obj, self.max_obj = sorted(n_objects)
        self.max_speed = max_speed
        self.max_acc = max_acc
        self.noise_std = noise_std

    def draw(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        """The random draws of one batch, on the generator's device: nums [B]
        object counts, idx [B, M] template indices, init_pos [B M, 2] first
        positions, and the trajectories' vel, acc [B M, 2] and noise
        [T - 1, B M, 2] (``draw_noisy_acceleration``)."""
        (H, W), (th, tw) = self.canvas_size, self.templates.shape[1:3]
        B, M = batch_size, max(self.max_obj, 1)  # keep one (masked) slot if 0
        device = generator.device

        nums = torch.randint(self.min_obj, self.max_obj + 1, (B,), generator=generator,
                             device=device)
        idx = torch.randint(0, self.templates.shape[0], (B, M), generator=generator,
                            device=device)
        span = torch.tensor([H - th, W - tw], dtype=torch.float32, device=device)
        init_pos = torch.rand((B * M, 2), generator=generator, device=device) * span
        return dict(nums=nums, idx=idx, init_pos=init_pos,
                    **draw_noisy_acceleration(generator, self.n_timesteps, B * M,
                                              self.max_speed, self.max_acc))

    def render(self, draws: Dict) -> Dict[str, torch.Tensor]:
        """The batch of ``draws`` (tensors or arrays, moved to the bank's
        device).

        :return: dict(imgs [T, B, H, W] float32 in [0, 1], nums [T, B, M + 1]
            cumulative one-hot counts, coords [T, B, M, 4] (y, x, h, w) boxes,
            zero for absent objects)
        """
        d = {k: torch.as_tensor(v).to(self.device) for k, v in draws.items()}
        T, (H, W) = self.n_timesteps, self.canvas_size
        th, tw = self.templates.shape[1:3]
        B, M = d["idx"].shape
        nums = d["nums"].to(torch.int64)
        obj_mask = (torch.arange(M, device=self.device)[None] < nums[:, None]).to(torch.float32)
        obj_templates = self.templates[d["idx"].to(torch.int64)]  # [B, M, th, tw]

        pos_bounds = [[0.0, float(H - th)], [0.0, float(W - tw)]]
        tjs = noisy_acceleration(d["init_pos"], d["vel"], d["acc"], d["noise"], pos_bounds,
                                 self.max_speed, self.max_acc, self.noise_std)
        tjs = tjs.reshape(T, B, M, 2)

        # an axis-aligned paste of a [th, tw] template at pixel (y, x): the ST
        # coords of the (y, x, th, tw) box
        size = torch.tensor([float(th), float(tw)], device=self.device)
        boxes = torch.cat([tjs, size.expand(T, B, M, 2)], -1)
        coords_stn = stn.pixel_to_stn_coords(boxes, (H, W))  # [T, B, M, 4]
        pasted = stn.paste_glimpse(obj_templates[None].expand(T, B, M, th, tw), coords_stn,
                                   (H, W))  # [T, B, M, H, W]
        pasted = pasted * obj_mask[None, :, :, None, None]
        imgs = torch.amax(pasted, 2)

        cum_onehot = (torch.arange(M + 1, device=self.device)[None] < nums[:, None]).to(
            torch.float32)
        return dict(imgs=imgs, nums=cum_onehot[None].expand(T, B, M + 1),
                    coords=boxes * obj_mask[..., None])

    def __call__(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        return self.render(self.draw(generator, batch_size))
