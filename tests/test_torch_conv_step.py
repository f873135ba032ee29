"""The conv model (``configs/conv_mnist_model.py``: ConvEncoder input and
glimpse encoders, a SubpixelDecoder) held to the JAX package's
``conv_mnist_model``: the eval step's metrics and the train record's
target, metrics and every parameter's gradient, at a narrow width
(n_units 1, conv_channels "4,8", n_what 8, 2 slots, k 2) on 26x26 frames
(26 -> 13 -> 7: both of flax's stride-2 paddings) with 10x10 glimpses,
B = 4, T = 3.  Both models come from their config loaders at the same
flags; the JAX weights are converted and the JAX model's noise replayed.
JAX runs its Pallas kernels in interpret mode.

Tolerances, those of tests/test_torch_pedestrian_step.py: metrics 1e-4 on
|a - b| / (|b| + 1); gradients 1e-4 of each leaf's largest |gradient| in
JAX (+1e-7).  With both switches set the conv model fuses nothing (JAX's
gates refuse a ConvEncoder): the port's step then gives the switch-off
step's metrics, with no fused glimpse, propagation or discovery call.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sqair_tpu.configs.conv_mnist_model as jconv_model
from sqair_tpu.experiment import flags as jflags
from sqair_tpu.models import Model as JModel
from sqair_tpu.training import make_eval_step as jax_make_eval_step
from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops import fused, fused_cells, fused_glimpse
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.training import make_eval_step
from torch_parity import assert_close, jax_noise_table, step_grads, to_numpy, \
    tpu_kernels_interpreted
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

METRIC_TOL = 1e-4
GRAD_TOL = 1e-4
B, T, H = 4, 3, 26
FLAGS = dict(mlp_mnist_model.DEFAULTS, n_units=1, n_what=8, n_steps_per_image=2,
             k_particles=2, glimpse_size=10, conv_channels="4,8", conv_kernel=3)
BOTH = {"SQAIR_FUSE_CELLS": "1", "SQAIR_FUSE_GLIMPSE": "1"}


@contextlib.contextmanager
def jax_flags(values):
    saved = dict(jflags.FLAGS._values)
    try:
        for name, value in values.items():
            setattr(jflags.FLAGS, name, value)
        yield
    finally:
        jflags.FLAGS._values.clear()
        jflags.FLAGS._values.update(saved)


def conv_batch():
    """(obs [T, B, 26, 26], nums [T, B, 3]): bright squares that move on a
    dim textured background."""
    rs = np.random.default_rng(11)
    obs = (rs.uniform(size=(T, B, H, H)) * 0.2).astype(np.float32)
    nums = np.zeros((T, B, 3), np.float32)
    for t in range(T):
        obs[t, :, 3 + t:11 + t, 4:12] += 0.8
        obs[t, 1::2, 14:22, 13 - t:21 - t] += 0.8
    nums[..., 1] = 1
    nums[:, 1::2, 1], nums[:, 1::2, 2] = 0, 1
    return obs, nums


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model with them, obs, nums)."""
    obs, nums = conv_batch()
    with jax_flags(FLAGS):
        jmodel = jconv_model.load(obs, mean_img=obs.mean((0, 1)))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    model = conv_mnist_model.load(FLAGS, (H, H), mean_img=obs.mean((0, 1)), device="cpu")
    load_flax_params(model.sequence, to_numpy(params))
    ts = model.sequence.timestep
    assert ts._input_encoder.MLP_0.w_0.shape == (7 * 7 * 8, 32)
    assert not ts.discover.fused_disc_eligible()
    assert ts._glimpse_encoder._fused_params() is None
    return jmodel, params, model, obs, nums


@functools.lru_cache(maxsize=None)
def _jax_table(seed):
    return jax_noise_table(jax.random.PRNGKey(seed), T, FLAGS["n_steps_per_image"],
                           B * FLAGS["k_particles"], FLAGS["n_what"])


def test_conv_eval_step_matches_jax(pair):
    jmodel, params, model, obs, nums = pair
    with tpu_kernels_interpreted():
        want = jax_make_eval_step(jmodel)(params, jax.random.PRNGKey(2), jnp.asarray(obs),
                                          jnp.asarray(nums))
    got = make_eval_step(model)(obs, nums, ReplayNoise(_jax_table(2), "cpu"))
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert_close(got[key].numpy(), np.asarray(want[key]), METRIC_TOL, key)


def test_conv_step_fuses_nothing_under_both_switches(pair, monkeypatch):
    """JAX's gates refuse the conv model's glimpse encoder (one-layer
    MLP_0), so neither the glimpse nor the frame kernels run: the same
    metrics, bit for bit, and no fused glimpse, propagation or discovery
    call."""
    _, _, model, obs, nums = pair
    off = make_eval_step(model)(obs, nums, ReplayNoise(_jax_table(2), "cpu"))
    for name, value in BOTH.items():
        monkeypatch.setenv(name, value)
    calls = []
    for module, name in ((fused_glimpse, "fused_glimpse_encoder"),
                         (fused_cells, "fused_prop_ssm"), (fused_cells, "fused_disc_ssm")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    mlp_calls = []
    real_mlp = fused.fused_mlp
    monkeypatch.setattr(fused, "fused_mlp", lambda x, p, t: mlp_calls.append(
        (x.shape[-1], p[-1][0].shape[-1])) or real_mlp(x, p, t))
    on = make_eval_step(model)(obs, nums, ReplayNoise(_jax_table(2), "cpu"))
    assert calls == []
    # the conv encoders' and the subpixel decoder's one-layer MLPs run as fused_mlp
    assert {(7 * 7 * 8, 32), (3 * 3 * 8, 32), (8, 400)} <= set(mlp_calls)
    for key in off:
        assert np.array_equal(on[key].numpy(), off[key].numpy()), key


def test_conv_train_gradients_match_jax(pair):
    jmodel, params, model, obs, nums = pair
    rng = jax.random.PRNGKey(4)

    def loss(p):
        target, aux = jmodel.loss_and_metrics(p, rng, jnp.asarray(obs), jnp.asarray(nums), 0.0,
                                              record_mode="train")
        return target, JModel.finalize_metrics(aux["metrics"])

    with tpu_kernels_interpreted():
        (_, want_metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    got, aux = step_grads(model, obs, nums, ReplayNoise(_jax_table(4), "cpu"))
    metrics = Model.finalize_metrics(aux["metrics"])
    for key, want in to_numpy(want_metrics).items():
        assert_close(metrics[key].detach().numpy(), want, METRIC_TOL, key)
    want_grads = params_from_flax(to_numpy(grads))
    assert sorted(got) == sorted(want_grads)
    moved = 0
    for name, want in want_grads.items():
        want = want.numpy().astype(np.float64)
        err = float(np.max(np.abs(got[name].numpy() - want))) if want.size else 0.0
        tol = GRAD_TOL * float(np.max(np.abs(want))) + 1e-7
        assert err <= tol, f"d{name}: {err:.3g} > {tol:.3g}"
        moved += bool(np.any(want))
    # the conv kernels' and the subpixel decoder's gradients are among them
    for name in ("timestep._input_encoder.ConvNet_0.Conv_0.kernel",
                 "timestep._glimpse_encoder.glimpse_encoder.ConvNet_0.Conv_1.kernel",
                 "decoder._glimpse_decoder.UpConvNet_0.Conv_2.kernel"):
        assert np.any(want_grads[name].numpy()), name
    assert moved > len(want_grads) - 4


def test_eval_cli_and_rollout_build_the_conv_model_from_flags_json(pair, tmp_path):
    """scripts/eval.py sweeps a conv run's checkpoint and scripts/rollout.py
    rolls it out, each building the conv model from the run's flags.json
    (its model_config and conv flags)."""
    import json

    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.scripts import eval as port_eval
    from sqair_tpu_torch.scripts import rollout
    from sqair_tpu_torch.training.checkpoint import save_checkpoint

    _, _, model, obs, nums = pair
    run_dir = tmp_path / "1"
    save_checkpoint(str(run_dir), 5, model.sequence)
    with open(run_dir / "flags.json", "w") as f:
        json.dump(dict(FLAGS, model_config="sqair_tpu/configs/conv_mnist_model.py"), f)
    npz = tmp_path / "valid.npz"
    np.savez(npz, imgs=np.round(obs * 255).astype(np.uint8), nums=nums)
    assert port_eval.main(["--checkpoint_dir", str(run_dir), "--data_npz", str(npz),
                           "--eval_batch_size", str(B), "--device", "cpu"]) == [5]
    with open(run_dir / "logpx_valid.txt") as f:
        assert np.isfinite(float(f.read().split(":")[1]))

    # the rollout's data config (the synthetic one) makes 50x50 frames
    flags = dict(FLAGS, k_particles=1, conv_channels="2,4",
                 model_config="sqair_tpu/configs/conv_mnist_model.py",
                 data_config="sqair_tpu/configs/synth_seq_mnist_data.py",
                 synth_valid_samples=2, synth_train_samples=2, synth_timesteps=3)
    run_dir = tmp_path / "50" / "1"
    save_checkpoint(str(run_dir), 3, conv_mnist_model.load(
        flags, (50, 50), mean_img=np.zeros((50, 50), np.float32), device="cpu").sequence)
    with open(run_dir / "flags.json", "w") as f:
        json.dump(flags, f)
    pflags.reset()
    try:
        out = rollout.main([f"--checkpoint_dir={run_dir}", f"--out_dir={tmp_path / 'r'}",
                            "--device=cpu", "--n_examples=2", "--rollout_len=4",
                            "--condition_frames=2"])
    finally:
        pflags.reset()
    assert out["outputs"]["canvas"].shape[0] == 4
    assert all(bool(v.isfinite().all()) for v in out["outputs"].values())
    assert float(out["outputs"]["disc_pres"][2:].abs().max()) == 0.0
