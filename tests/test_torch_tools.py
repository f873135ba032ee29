"""The port's tools, notebook and native binding on the CPU, at tiny widths:
tools/time_step_torch.py, profile_step_torch.py, eval_one_ckpt_torch.py,
diag_presence_logits_torch.py, promote_release_torch.py,
notebooks/play_torch.py (--checkpoint_dir and --quick_train, with and
without matplotlib) and sqair_tpu_torch/data/native.py, byte for byte
against sqair_tpu/data/native.py on the native path and with the library
hidden.  The tools read a 10-step run of the training CLI at the test-run
widths (B 8, k 2, T 2, 128 wide).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from sqair_tpu.data import native as jnative
from sqair_tpu_torch import eval_tools
from sqair_tpu_torch.data import native
from sqair_tpu_torch.experiment import flags as pflags
from sqair_tpu_torch.scripts import eval as port_eval
from sqair_tpu_torch.scripts import experiment as pexp
from sqair_tpu_torch.training import make_eval_step
from sqair_tpu_torch.training.checkpoint import load_checkpoint
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.join(REPO, "notebooks"))
import diag_presence_logits_torch  # noqa: E402
import eval_one_ckpt_torch  # noqa: E402
import play_torch  # noqa: E402
import profile_step_torch  # noqa: E402
import promote_release_torch  # noqa: E402
import time_step_torch  # noqa: E402

WIDTHS = ["--data_config=sqair_tpu/configs/synth_seq_mnist_data.py",
          "--model_config=sqair_tpu/configs/mlp_mnist_model.py", "--seq_len=2",
          "--eval_on_train=false", "--batch_size=8", "--k_particles=2", "--n_units=4",
          "--synth_train_samples=64", "--synth_valid_samples=96", "--synth_timesteps=3",
          "--device=cpu", "--on_device_data"]
STEPS = 10
TINY = ["--device", "cpu", "--batch_size", "2", "--timesteps", "2"]


def _fresh(fn, *args, **kw):
    """Runs ``fn`` from a clean flag registry, putting sys.argv back."""
    saved = sys.argv
    pflags.reset()
    try:
        return fn(*args, **kw)
    finally:
        sys.argv = saved
        pflags.reset()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    return _fresh(pexp.main, WIDTHS + [f"--train_itr={STEPS}", f"--save_itr={STEPS}",
                                       f"--report_loss_every={STEPS}", f"--log_itr={STEPS}",
                                       f"--fig_itr={STEPS}", f"--results_dir={root}",
                                       "--run_name=tiny"])[0]


def test_eval_one_ckpt(run_dir):
    out = _fresh(eval_one_ckpt_torch.main, [run_dir, str(STEPS), "2", "{}", "--device", "cpu"])
    # the tool's numbers: its batches 1 and 2 of the valid set's rolling
    # windows, each with the eval noise, through the eval step
    _, data, model = _fresh(eval_one_ckpt_torch.load_run, run_dir, 32, "cpu")
    eval_one_ckpt_torch.restore_params(os.path.join(run_dir, f"ckpt-{STEPS}"), model.sequence)
    imgs, nums = data["valid_data"]["imgs"], data["valid_data"]["nums"]
    step, noise = make_eval_step(model), port_eval.default_noise("cpu")
    want = [step(imgs[:, i * 32:(i + 1) * 32], nums[:, i * 32:(i + 1) * 32], noise())
            for i in (1, 2)]
    assert sorted(out) == sorted(want[0])
    for key, v in out.items():
        expect = (want[0][key].numpy().astype(np.float64) + want[1][key].numpy()) / 2
        np.testing.assert_allclose(v, expect, rtol=1e-12, err_msg=key)
    assert out["num_step_acc_per_t"].shape == (2,)
    moved = _fresh(eval_one_ckpt_torch.main, [run_dir, str(STEPS), "2",
                                              '{"early_disc_step_bias": 3.0}',
                                              "--device", "cpu"])
    assert moved["iwae"] != out["iwae"]  # the override reaches the model


def test_diag_presence_logits(run_dir, capsys):
    report = _fresh(diag_presence_logits_torch.main, [run_dir, str(STEPS), "--device", "cpu"])
    assert sorted(report) == [0, 1]
    for r in report.values():
        assert r["on_count"].size + r["over_count"].size <= r["kept"]
        assert all(np.isfinite(v).all() for v in (r["on_count"], r["over_count"], r["dropped"]))
    assert "t=0: kept slots" in capsys.readouterr().out


def test_promote_release_then_sweep(run_dir, tmp_path):
    out = str(tmp_path / "release" / "1")
    path = promote_release_torch.main(["--run_dir", run_dir, "--out", out])
    state = load_checkpoint(path)
    assert sorted(state) == ["params", "step"] and state["step"] == STEPS
    full = load_checkpoint(os.path.join(run_dir, f"ckpt-{STEPS}"))
    assert all(torch.equal(full["params"][k], v) for k, v in state["params"].items())
    with open(os.path.join(out, "flags.json")) as f, \
            open(os.path.join(run_dir, "flags.json")) as g:
        assert json.load(f) == json.load(g)
    npz = str(tmp_path / "valid.npz")
    rs = np.random.default_rng(0)
    np.savez(npz, imgs=rs.integers(0, 255, (2, 16, 50, 50), dtype=np.uint8),
             nums=np.eye(4, dtype=np.uint8)[rs.integers(0, 3, 16)][None])
    assert port_eval.main(["--checkpoint_dir", out, "--data_npz", npz, "--eval_batch_size", "8",
                           "--device", "cpu"]) == [STEPS]


def test_time_and_profile_step():
    out = time_step_torch.main(TINY + ["--steps", "2", "--trials", "1", "--chain", "2"])
    assert len(out["eager"]) == len(out["graph"]) == 1 and np.isfinite(out["warm_target"])
    prof = profile_step_torch.main(TINY + ["--iters", "1", "--warmup", "0"])
    assert sorted(prof) == sorted(["train step (fwd+bwd+opt)", "loss forward",
                                   "SequentialAIR forward (B*k)", "one timestep", "decoder",
                                   "loss fwd+bwd (no opt)"])
    assert all(v > 0 for v in prof.values())


@pytest.mark.parametrize("has_mpl", [True, False])
def test_play_on_a_run(run_dir, tmp_path, monkeypatch, capsys, has_mpl):
    monkeypatch.setattr(eval_tools, "_HAS_MPL", has_mpl and eval_tools._HAS_MPL)
    metrics, figs = _fresh(play_torch.main, ["--checkpoint_dir", run_dir, "--device", "cpu",
                                             "--eval_batches", "2",
                                             "--fig_dir", str(tmp_path / "figs")])
    assert np.isfinite(metrics["iwae"]) and metrics["num_steps_per_t"].shape == (2,)
    printed = capsys.readouterr().out
    assert f"restored step {STEPS}" in printed
    if eval_tools._HAS_MPL:
        assert len(figs) == 2 and all(os.path.exists(f) for f in figs)
    else:
        assert figs == [] and "figures skipped: matplotlib is not installed" in printed


def test_play_quick_train(tmp_path, monkeypatch):
    # the CLI's --test_run, cut from 200 steps to 10
    monkeypatch.setitem(pexp.TEST_RUN, "train_itr", STEPS)
    monkeypatch.setattr(eval_tools, "_HAS_MPL", False)
    metrics, _ = _fresh(play_torch.main, ["--quick_train", "--device", "cpu",
                                          "--results_dir", str(tmp_path), "--eval_batches", "1"])
    assert os.path.exists(tmp_path / "mnist_test" / "1" / f"ckpt-{STEPS}")
    assert np.isfinite(metrics["target"])


def _generate(module):
    bank = np.random.default_rng(3).uniform(0, 255, (5, 12, 12)).astype(np.float32)
    return module.generate_sequences(bank, 6, 4, canvas_size=(30, 30), n_objects=(0, 2),
                                     seed=7, n_threads=2)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_native_binding_matches_the_jax_package():
    assert native.native_available() and jnative.native_available()
    _same(_generate(native), _generate(jnative))


def test_native_binding_without_the_library(monkeypatch):
    for module in (native, jnative):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_lib_tried", True)
    assert not native.native_available()
    got = _generate(native)
    _same(got, _generate(jnative))
    assert got["imgs"].shape == (4, 6, 30, 30)


def test_native_binding_falls_back_where_the_library_dies(monkeypatch):
    """A library that dies on this host (as one built for another
    instruction set does) is never picked: the numpy path runs."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "_PROBE", "import os; os.abort()")
    assert not native.native_available()
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_tried", True)
    _same(_generate(native), _generate(jnative))
