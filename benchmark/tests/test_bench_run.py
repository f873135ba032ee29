"""A run's behaviour without a card, its imports, and the check that
decides ``correct`` against faults planted in the program, all on the
CPU at a tiny size (``harness.runner.run`` driven past the look for a
card)."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from helpers import BENCH, ROOT, tiny_cell
from harness import imports, runner

CELLS = ["mlp_release-train-fused", "conv_mnist-train"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0], "--seed",
         "2147483647", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (the test session's conftest imports JAX):
    everything a run imports, then the check."""
    probe = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
        import run
        from harness import imports, runner, program
        from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model
        from sqair_tpu_torch.data import DeviceDatasetSampler
        from sqair_tpu_torch.training import init_train
        from sqair_tpu_torch.training.graph import make_chained_train_step
        print(imports.forbidden())
        """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole():
    names = ["sqair_tpu_torch.ops", "sqair_tpu_torch", "jaxtyping", "flax.linen",
             "sqair_tpu.models", "jax"]
    assert imports.forbidden(names) == ["flax", "jax", "sqair_tpu"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = runner.run(tiny_cell(workload), 2**31 + 11, 0.2, False, "cpu")["result"]
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert json.loads(json.dumps(out)) == out


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(workload, monkeypatch):
    from sqair_tpu_torch.training import train

    def unchanged(self, closure=None, lr=None):
        self.count += 1

    monkeypatch.setattr(train.TFRMSProp, "step", unchanged)
    out = runner.run(tiny_cell(workload), 2**31 + 12, 0.2, False, "cpu")["result"]
    assert out["correct"] is False
    assert out["checks"]["change"]["value"] > out["checks"]["change"]["limit"]


class _FirstHalf:
    """A noise source that draws each noise for the whole batch (every
    draw's first axis is the B * k particles, example-major) and hands back
    the first half's rows."""

    def __init__(self, source):
        self.source = source

    def scope(self, *names):
        return _FirstHalf(self.source.scope(*names))

    def normal(self, name, shape):
        return self.source.normal(name, (2 * shape[0],) + tuple(shape[1:]))[:shape[0]]

    def uniform(self, name, shape):
        return self.source.uniform(name, (2 * shape[0],) + tuple(shape[1:]))[:shape[0]]


def _half_batch(monkeypatch, noise):
    from sqair_tpu_torch.models import model

    whole = model.Model.loss_and_metrics

    def half(self, obs, source, gt_presence=None, **kwargs):
        b = obs.shape[1] // 2
        return whole(self, obs[:, :b], noise(source), gt_presence[:, :b], **kwargs)

    monkeypatch.setattr(model.Model, "loss_and_metrics", half)


@pytest.mark.parametrize("workload", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(workload, monkeypatch):
    """The first half of each batch, with the noise those examples drew in
    the whole batch's step: the steps pair with the reference's, and a
    number reads over its limit."""
    _half_batch(monkeypatch, _FirstHalf)
    out = runner.run(tiny_cell(workload), 2**31 + 13, 0.2, False, "cpu")
    checks = out["result"]["checks"]
    assert out["info"]["reference_error"] is None
    assert all(c["value"] is not None for c in checks.values()), checks
    assert out["result"]["correct"] is False
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


@pytest.mark.parametrize("workload", CELLS)
def test_noise_that_cannot_be_paired_is_not_correct(workload, monkeypatch):
    """A half batch that draws only its own noise: the reference asks for
    the whole batch's, the steps cannot be paired, and every number is NaN."""
    _half_batch(monkeypatch, lambda source: source)
    out = runner.run(tiny_cell(workload), 2**31 + 14, 0.2, False, "cpu")
    assert out["result"]["correct"] is False
    assert "noise" in out["info"]["reference_error"]
