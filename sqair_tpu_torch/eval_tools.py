"""Metric sinks, evaluation loggers and progress figures (the port of
sqair_tpu/eval_tools.py).

Channels: stdout, tensorboardX scalars, histograms and images where
tensorboardX is installed, a metrics.jsonl file with the same records and
keys as the JAX package's, and matplotlib still and sequence figures with
boxes coloured by object id where matplotlib is installed (without it
``ProgressFig.plot_all`` returns before it renders, as the JAX package's
does).
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .ops import stn

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _HAS_MPL = True
except ImportError:
    _HAS_MPL = False


def to_numpy(value) -> np.ndarray:
    """A metric (tensor on any device, or array-like) as float64 numpy."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float64)


class MetricWriter:
    """Scalar sink: tensorboardX (optional) + metrics.jsonl."""

    def __init__(self, logdir: str, use_tb: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tb:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(logdir)

    def write(self, step: int, values: Dict[str, float], prefix: str = ""):
        record = {"step": int(step)}
        for k, v in values.items():
            tag = f"{k}/{prefix}" if prefix else k
            v = float(v)
            record[tag] = v
            if self._tb is not None:
                self._tb.add_scalar(tag, v, step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def write_histogram(self, step: int, tag: str, values):
        """A per-variable histogram (tensorboard only)."""
        if self._tb is not None:
            self._tb.add_histogram(tag, to_numpy(values).ravel(), step)

    def write_image(self, step: int, tag: str, img):
        """An HW or HWC float image in [0, 1] (tensorboard only): the
        figures' fallback."""
        if self._tb is None:
            return
        img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
        if img.ndim == 2:
            img = img[None]  # -> CHW
        elif img.ndim == 3 and img.shape[-1] in (1, 3):
            img = np.moveaxis(img, -1, 0)
        self._tb.add_image(tag, img, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def make_expr_logger(eval_fn: Callable, batcher, num_batches: int, name: str,
                     writer: Optional[MetricWriter] = None,
                     seq_len_fn: Optional[Callable] = None):
    """Multi-batch averaged evaluation.

    :param eval_fn: (obs, nums) -> dict of scalar (or [T]) metrics
    :param batcher: iterator of numpy batches with 'imgs'/'nums'
    """

    def logger(itr: int = 0, num_batches_to_eval: Optional[int] = None, write=True):
        totals = collections.defaultdict(float)
        n = num_batches_to_eval or num_batches
        start = time.time()
        for _ in range(n):
            batch = next(batcher)
            if seq_len_fn is not None:
                sl = seq_len_fn(itr)
                batch = {k: v[:sl] for k, v in batch.items()}
            metrics = eval_fn(batch["imgs"], batch["nums"])
            for k, v in metrics.items():
                # scalar metrics, plus [T] vectors (num_step_acc_per_t)
                totals[k] = totals[k] + to_numpy(v)
        l = {k: v / n for k, v in totals.items()}
        t = time.time() - start

        def _fmt(v):
            return ("[" + " ".join(f"{x:.3f}" for x in v) + "]"
                    if np.ndim(v) else f"{v:.4f}")
        msg = ", ".join(f"{k} = {_fmt(v)}" for k, v in sorted(l.items()))
        print(f"Step {itr}, Data {name} {msg}, eval time = {t:.4}s")
        if writer is not None and write:
            flat = {}
            for k, v in l.items():
                if np.ndim(v):
                    flat.update({f"{k}{i}": float(x) for i, x in enumerate(v)})
                else:
                    flat[k] = v
            writer.write(itr, flat, prefix=name)
        return l

    return logger


def make_logger(eval_fn, writer, train_batcher, num_train_batches, valid_batcher,
                num_valid_batches, eval_on_train: bool, seq_len_fn=None):
    """The test set's logger, and the train set's before it when
    ``eval_on_train``."""
    test_log = make_expr_logger(
        eval_fn, valid_batcher, num_valid_batches, "test", writer, seq_len_fn
    )
    if eval_on_train:
        train_log = make_expr_logger(
            eval_fn, train_batcher, num_train_batches, "train", writer, seq_len_fn
        )

        def log(itr):
            train_log(itr)
            test_log(itr)
            print()
    else:

        def log(itr):
            test_log(itr)
            print()

    return log


# ------------------------------------------------------------------ figures

def rect_from_stn(ax, stn_coords, img_size, color, lw=1.5):
    """Draws one box given in ST coordinates."""
    import matplotlib.patches as patches

    y, x, h, w = stn.stn_to_pixel_coords(torch.as_tensor(stn_coords), img_size).tolist()
    r = patches.Rectangle((x, y), w, h, linewidth=lw, edgecolor=color, facecolor="none")
    ax.add_patch(r)
    return r


_ID_COLORS = ("r", "g", "b", "c", "m", "y", "w", "orange", "lime", "purple")


def id_color(obj_id: float) -> str:
    return _ID_COLORS[int(obj_id) % len(_ID_COLORS)]


class ProgressFig:
    """Still and sequence reconstruction figures, ``still_fig_<itr>.png``
    and ``seq_fig_<itr>.png`` in ``logdir``.

    ``sample_fn(obs, nums)`` returns the model's render dict (the
    resampled_* tensors of ``Model.loss_and_metrics(..., render=True)``
    and "obs").
    """

    def __init__(self, sample_fn, logdir, img_size, glimpse_size,
                 n_samples: int = 5, seq_n_samples: int = 4, fig_scale: float = 1.5,
                 dpi: int = 100):
        self.sample_fn = sample_fn
        self.logdir = logdir
        self.img_size = img_size
        self.glimpse_size = glimpse_size
        self.n_samples = n_samples
        self.seq_n_samples = seq_n_samples
        self.fig_scale = fig_scale
        self.dpi = dpi
        os.makedirs(logdir, exist_ok=True)

    def plot_all(self, itr, batch, close: bool = True):
        if not _HAS_MPL:
            return
        render = self.sample_fn(batch["imgs"], batch["nums"])
        render = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                  for k, v in render.items()}
        self.plot_still(itr, render, close)
        self.plot_seq(itr, render, close)

    def plot_still(self, itr, r, close=True):
        """A ground-truth row, a reconstruction row with boxes and a row of
        glimpses per slot, for frame 0."""
        obs = r["obs"][0]
        canvas = r["resampled_canvas"][0]
        glimpse = r["resampled_glimpse"][0]
        presence = r["resampled_presence"][0]
        where = to_coords(r["resampled_where"][0])
        obj_id = r["resampled_obj_id"][0]

        n = min(self.n_samples, obs.shape[0])
        n_steps = glimpse.shape[1]
        h = 2 + n_steps
        fig, axes = plt.subplots(h, n, figsize=self.fig_scale * np.asarray((n, h)))
        axes = np.atleast_2d(axes)
        for i in range(n):
            axes[0, i].imshow(obs[i], cmap="gray", vmin=0, vmax=1)
            axes[1, i].imshow(np.clip(canvas[i], 0, 1), cmap="gray", vmin=0, vmax=1)
            for k in range(n_steps):
                if presence[i, k] > 0.5:
                    rect_from_stn(axes[1, i], where[i, k], self.img_size,
                                  id_color(obj_id[i, k]))
                axes[2 + k, i].imshow(glimpse[i, k], cmap="gray")
        for ax in axes.ravel():
            ax.set_xticks([])
            ax.set_yticks([])
        self._save(fig, f"still_fig_{itr}.png", close)

    def plot_seq(self, itr, r, close=True):
        """Two rows per sample (frames, reconstructions with boxes) by T
        columns, boxes coloured by object id."""
        obs = r["obs"]
        canvas = r["resampled_canvas"]
        presence = r["resampled_presence"]
        where = to_coords(r["resampled_where"])
        obj_id = r["resampled_obj_id"]

        T = obs.shape[0]
        n = min(self.seq_n_samples, obs.shape[1])
        fig, axes = plt.subplots(2 * n, T, figsize=self.fig_scale * np.asarray((T, 2 * n)))
        axes = np.atleast_2d(axes)
        for i in range(n):
            for t in range(T):
                axes[2 * i, t].imshow(obs[t, i], cmap="gray", vmin=0, vmax=1)
                axes[2 * i + 1, t].imshow(np.clip(canvas[t, i], 0, 1), cmap="gray",
                                          vmin=0, vmax=1)
                for k in range(presence.shape[-1]):
                    if presence[t, i, k] > 0.5:
                        rect_from_stn(axes[2 * i + 1, t], where[t, i, k],
                                      self.img_size, id_color(obj_id[t, i, k]))
        for ax in axes.ravel():
            ax.set_xticks([])
            ax.set_yticks([])
        self._save(fig, f"seq_fig_{itr}.png", close)

    def _save(self, fig, name, close):
        fig.savefig(os.path.join(self.logdir, name), dpi=self.dpi, bbox_inches="tight")
        if close:
            plt.close(fig)


def to_coords(where_logit: np.ndarray) -> np.ndarray:
    """where logits -> ST coordinates, as numpy."""
    return stn.to_coords(torch.as_tensor(where_logit)).numpy()
