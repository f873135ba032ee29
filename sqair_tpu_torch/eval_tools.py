"""Metric sinks and evaluation loggers (the port of sqair_tpu/eval_tools.py:
``MetricWriter``, ``make_expr_logger``, ``make_logger``).

Channels: stdout, tensorboardX scalars and histograms where tensorboardX is
installed, and a metrics.jsonl file with the same records and keys as the
JAX package's.  The progress figures (``ProgressFig``) are not ported yet.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


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
