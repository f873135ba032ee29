"""The figures' tensors and the figures, and the port's release checkpoint.

- ``Model.loss_and_metrics(..., render=True)``: the resampling index and
  the render dict held to sqair_tpu's (full record, golden config, k 5, the
  JAX weights converted, its noise and its resampling draw replayed:
  ``jax_resample_noise``).  The index must equal JAX's for every example
  whose two largest Gumbel-perturbed log-weights lie more than 1e-3 apart
  (nearer, f32 differences of the weights may reorder them); the render
  tensors of those examples at 1e-4 on |a - b| / (|b| + 1).
- ``eval_tools.ProgressFig`` writes still_fig_<itr>.png and seq_fig_<itr>.png
  with the same pixels as the JAX package's from the same render dict.
- The training CLI writes the figures at the start, every --fig_itr steps
  and the end, the same files as the JAX package's CLI; where a figure fails
  it writes the raw render tensors as images instead.
- sqair_tpu_torch/release/mnist_mlp/1: ckpt-1000000 is byte for byte what
  tools/jax_ckpt_to_torch.py writes from the orbax release checkpoint, and
  its flags.json the release run's.
"""
import filecmp
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import image as mpimg

from sqair_tpu import eval_tools as jeval_tools
from sqair_tpu.experiment import flags as jflags
from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.scripts import experiment as jexp
from sqair_tpu_torch import eval_tools
from sqair_tpu_torch.convert import load_flax_params
from sqair_tpu_torch.experiment import flags as pflags
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.models.model import resampling_index
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.scripts import experiment as pexp
from torch_parity import (B, NWHAT, S, T, assert_close, build_pair, golden_batch,
                          jax_noise_table, jax_resample_noise, to_numpy)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = os.path.join(REPO, "release_models", "mnist_mlp", "1")
PORT_RELEASE = os.path.join(REPO, "sqair_tpu_torch", "release", "mnist_mlp", "1")
sys.path.insert(0, os.path.join(REPO, "tools"))
import jax_ckpt_to_torch  # noqa: E402

TOL = 1e-4
GAP = 1e-3  # between the two largest Gumbel-perturbed log-weights
K = 5
CLI = ["--data_config=sqair_tpu/configs/synth_seq_mnist_data.py",
       "--model_config=sqair_tpu/configs/mlp_mnist_model.py", "--seq_len=2",
       "--eval_on_train=false", "--batch_size=8", "--k_particles=2", "--n_units=4",
       "--synth_train_samples=64", "--synth_valid_samples=32", "--synth_timesteps=3",
       "--train_itr=2", "--fig_itr=1", "--log_itr=2", "--save_itr=2", "--report_loss_every=1",
       "--run_name=r"]


@pytest.fixture(scope="module")
def rendered():
    """(JAX's render and log-weights, the port's aux, the JAX rng) of one
    full-record step."""
    jts, jdec, seq = build_pair()
    jmodel = JModel(JSequentialAIR(jts, jdec), k_particles=K)
    obs, nums = golden_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    rng = jax.random.PRNGKey(4)
    _, jaux = jax.jit(lambda p, r, o, n: jmodel.loss_and_metrics(p, r, o, n))(
        params, rng, jnp.asarray(obs), jnp.asarray(nums))
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=K)
    table = {**jax_noise_table(rng, T, S, B * K, NWHAT), **jax_resample_noise(rng, B, K)}
    with torch.inference_mode():
        _, aux = model.loss_and_metrics(torch.from_numpy(obs), ReplayNoise(table, "cpu"),
                                        torch.from_numpy(nums), render=True)
    return to_numpy(jaux["render"]), np.asarray(jaux["log_weights"]), aux, rng


def test_resampling_index_and_render_match_jax(rendered):
    jrender, jlog_weights, aux, rng = rendered
    logits = np.log(np.asarray(jax.nn.softmax(jlog_weights, -1)) + 1e-38)
    key = jax.random.fold_in(rng, 0x5E5A)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), -1))
    perturbed = np.sort(np.asarray(jax.random.gumbel(key, logits.shape)) + logits, -1)
    clear = perturbed[:, -1] - perturbed[:, -2] > GAP
    assert clear.sum() >= B - 1, perturbed
    weights = torch.softmax(aux["log_weights"], -1)
    got = resampling_index(weights, ReplayNoise(jax_resample_noise(rng, B, K), "cpu")).numpy()
    np.testing.assert_array_equal(got[clear], want[clear])
    render = aux["render"]
    assert sorted(render) == sorted(jrender)
    for name, value in jrender.items():
        assert_close(render[name].numpy()[:, clear], value[:, clear], TOL, name)


def test_progress_figures_match_jax(rendered, tmp_path):
    jrender = rendered[0]
    batch = dict(imgs=jrender["obs"], nums=None)
    size, glimpse = jrender["obs"].shape[2:], [8, 8]
    jeval_tools.ProgressFig(lambda obs, nums: jrender, str(tmp_path / "jax"), size,
                            glimpse).plot_all(7, batch)
    eval_tools.ProgressFig(lambda obs, nums: {k: torch.tensor(v) for k, v in jrender.items()},
                           str(tmp_path / "port"), size, glimpse).plot_all(7, batch)
    assert sorted(os.listdir(tmp_path / "port")) == ["seq_fig_7.png", "still_fig_7.png"]
    for name in ("seq_fig_7.png", "still_fig_7.png"):
        got, want = (mpimg.imread(str(tmp_path / side / name)) for side in ("port", "jax"))
        np.testing.assert_array_equal(got, want, err_msg=name)


def _jax_cli(argv):
    saved = dict(jflags.FLAGS._values), set(jflags.FLAGS._cli_set), sys.argv
    try:
        jexp.main(argv)
    finally:
        jflags.FLAGS._values.clear()
        jflags.FLAGS._values.update(saved[0])
        jflags.FLAGS._cli_set.clear()
        jflags.FLAGS._cli_set.update(saved[1])
        sys.argv = saved[2]


def _port_cli(argv):
    saved = sys.argv
    pflags.reset()
    try:
        return pexp.main(argv)
    finally:
        sys.argv = saved
        pflags.reset()


def _figures(run_dir):
    return sorted(f for f in os.listdir(run_dir) if f.endswith(".png"))


def test_cli_writes_the_figures_as_jax_does(tmp_path, monkeypatch):
    monkeypatch.setenv("SQAIR_NO_COMPILE_CACHE", "1")
    _jax_cli(CLI + [f"--results_dir={tmp_path / 'jax'}", "--data_parallel=false"])
    _port_cli(CLI + [f"--results_dir={tmp_path / 'port'}", "--device=cpu"])
    want = _figures(tmp_path / "jax" / "r" / "1")
    assert want == sorted(f"{kind}_fig_{i}.png" for kind in ("seq", "still") for i in range(3))
    assert _figures(tmp_path / "port" / "r" / "1") == want


def test_cli_falls_back_to_render_images(tmp_path, monkeypatch):
    def fail(self, itr, batch, close=True):
        raise RuntimeError("no figure")

    images = []
    monkeypatch.setattr(eval_tools.ProgressFig, "plot_all", fail)
    monkeypatch.setattr(eval_tools.MetricWriter, "write_image",
                        lambda self, itr, tag, img: images.append((itr, tag, img.shape)))
    _port_cli(CLI + [f"--results_dir={tmp_path}", "--device=cpu", "--train_itr=1"])
    # T = 2 frames of 50 x 50 side by side, at the start, step 1 and the end
    assert images == [(i, tag, (50, 100)) for i in (0, 1, 1)
                      for tag in ("render/obs", "render/resampled_canvas")]


def test_release_checkpoint_is_the_converters_output(tmp_path):
    jax_ckpt_to_torch.main(["--checkpoint", os.path.join(RELEASE, "ckpt-1000000"),
                            "--out_dir", str(tmp_path)])
    assert sorted(os.listdir(PORT_RELEASE)) == ["ckpt-1000000", "flags.json"]
    for name in ("ckpt-1000000", "flags.json"):
        assert filecmp.cmp(tmp_path / name, os.path.join(PORT_RELEASE, name), shallow=False), name
    with open(os.path.join(PORT_RELEASE, "flags.json")) as f:
        assert json.load(f)["data_config"] == "sqair_tpu/configs/font_seq_mnist_data.py"
