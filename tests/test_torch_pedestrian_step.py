"""The pedestrian configuration (``configs/pedestrian_model.py``: a
non-square glimpse on non-square frames) held to the JAX package's
``pedestrian_model``: the eval step's metrics and the train record's
target, metrics and every parameter's gradient, with no switch and with
both switches (``SQAIR_FUSE_CELLS=1`` and ``SQAIR_FUSE_GLIMPSE=1``: at the
module defaults the discovery fuses too), at a narrow width (n_units 1,
n_what 8, 2 slots, k 3), 40x30 frames of the port's pedestrian data and
16x6 glimpses, B = 4, T = 3: the shapes of the JAX package's own
non-square test (tests/test_configs_rollout.py).  Both models come from
their config loaders at the same flags; the JAX weights are converted and
the JAX model's noise replayed (slot-major where its fused paths draw it).
JAX runs its Pallas kernels in interpret mode.

Tolerances, those of tests/test_torch_train_grads.py (switch off) and
tests/test_torch_cells_step.py / test_torch_disc_step.py (switches on):
metrics 1e-4 on |a - b| / (|b| + 1); gradients 1e-4 of each leaf's
largest |gradient| in JAX (+1e-7), with both switches on or twice JAX's
own distance from the float64 value of its step where that is larger (the
port's switch-off step in float64 under JAX's noise: none of the code
under test).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sqair_tpu.configs.pedestrian_model as jped_model
from sqair_tpu.experiment import flags as jflags
from sqair_tpu.models import Model as JModel
from sqair_tpu.ops import fused_cells as jcells
from sqair_tpu.training import make_eval_step as jax_make_eval_step
from sqair_tpu_torch.configs import mlp_mnist_model, pedestrian_model
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.data import create_pedestrian_dataset
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops import fused_cells
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.training import make_eval_step
from torch_parity import (assert_close, f64_step_grads, jax_noise_table, spy, step_grad_close,
                          step_grads, to_numpy, tpu_kernels_interpreted)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

METRIC_TOL = 1e-4
GRAD_TOL = 1e-4
B, T = 4, 3
FLAGS = dict(mlp_mnist_model.DEFAULTS, n_units=1, n_what=8, n_steps_per_image=2, k_particles=3,
             glimpse_hw="16,6")
CANVAS, OBJ = (40, 30), (32, 12)
SWITCHES = {"off": {}, "both": {"SQAIR_FUSE_CELLS": "1", "SQAIR_FUSE_GLIMPSE": "1"}}


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


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model with them, obs, nums)."""
    data = create_pedestrian_dataset(n_samples=B, n_timesteps=T, canvas_size=CANVAS,
                                     obj_size=OBJ, seed=3)
    obs = data["imgs"].astype(np.float32) / 255.0
    nums = np.repeat(data["nums"].astype(np.float32), T, 0)
    assert obs.shape == (T, B) + CANVAS and nums.shape == (T, B, 3) and nums[..., 0].any()
    with jax_flags(FLAGS):
        jmodel = jped_model.load(obs)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    model = pedestrian_model.load(FLAGS, CANVAS, device="cpu")
    load_flax_params(model.sequence, to_numpy(params))
    ts = model.sequence.timestep
    assert ts._glimpse_encoder.glimpse_size == (16, 6) == model.sequence.decoder.glimpse_size
    assert ts.discover.fused_disc_eligible()
    return jmodel, params, model, obs, nums


@functools.lru_cache(maxsize=None)
def _jax_table(seed, fused):
    return jax_noise_table(jax.random.PRNGKey(seed), T, FLAGS["n_steps_per_image"],
                           B * FLAGS["k_particles"], FLAGS["n_what"], fused_prop=fused,
                           fused_disc=fused)


def _switched(mp, switches):
    for name in SWITCHES["both"]:
        if name in switches:
            mp.setenv(name, switches[name])
        else:
            mp.delenv(name, raising=False)


@pytest.mark.parametrize("setting", sorted(SWITCHES))
def test_pedestrian_eval_step_matches_jax(pair, setting):
    jmodel, params, model, obs, nums = pair
    rng = jax.random.PRNGKey(2)
    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        _switched(mp, SWITCHES[setting])
        jcalls = spy(mp, jcells, "fused_disc_ssm")
        calls = spy(mp, fused_cells, "fused_disc_ssm")
        want = jax_make_eval_step(jmodel)(params, rng, jnp.asarray(obs), jnp.asarray(nums))
        got = make_eval_step(model)(obs, nums,
                                    ReplayNoise(_jax_table(2, setting == "both"), "cpu"))
    # both switches: one fused discovery call a frame on each side
    assert (len(calls) == T and len(jcalls) > 0) == (setting == "both")
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert_close(got[key].numpy(), np.asarray(want[key]), METRIC_TOL, f"{setting} {key}")


@pytest.mark.parametrize("setting", sorted(SWITCHES))
def test_pedestrian_train_gradients_match_jax(pair, setting):
    jmodel, params, model, obs, nums = pair
    rng = jax.random.PRNGKey(4)
    table = _jax_table(4, setting == "both")

    def loss(p):
        target, aux = jmodel.loss_and_metrics(p, rng, jnp.asarray(obs), jnp.asarray(nums), 0.0,
                                              record_mode="train")
        return target, JModel.finalize_metrics(aux["metrics"])

    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        _switched(mp, SWITCHES[setting])
        calls = spy(mp, fused_cells, "fused_prop_ssm")
        (want_target, want_metrics), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
        got, aux = step_grads(model, obs, nums, ReplayNoise(table, "cpu"))
    assert (len(calls) == T) == (setting == "both")
    metrics = Model.finalize_metrics(aux["metrics"])
    for key, want in to_numpy(want_metrics).items():
        assert_close(metrics[key].detach().numpy(), want, METRIC_TOL, f"{setting} {key}")
    want_grads = params_from_flax(to_numpy(grads))
    assert sorted(got) == sorted(want_grads)
    if setting == "off":
        for name, want in want_grads.items():
            want = want.numpy().astype(np.float64)
            err = float(np.max(np.abs(got[name].numpy() - want))) if want.size else 0.0
            tol = GRAD_TOL * float(np.max(np.abs(want))) + 1e-7
            assert err <= tol, f"d{name}: {err:.3g} > {tol:.3g}"
    else:
        # the float64 value of JAX's step: the port's switch-off step under its noise
        jax64 = f64_step_grads(model, obs, nums, table)
        for name, want in want_grads.items():
            step_grad_close(got[name], want.numpy(), jax64[name], name)


def test_eval_cli_sweeps_a_pedestrian_checkpoint(pair, tmp_path):
    """The eval CLI builds the run's model config (flags.json's
    model_config): a pedestrian run's checkpoint, with its 16x6 glimpse,
    restores and sweeps to finite metrics, where the square default model
    config cannot restore it."""
    import json

    from sqair_tpu_torch.scripts import eval as port_eval
    from sqair_tpu_torch.training.checkpoint import save_checkpoint

    _, _, _, obs, nums = pair
    model = pedestrian_model.load(FLAGS, CANVAS, mean_img=obs.mean((0, 1)), device="cpu")
    run_dir = tmp_path / "1"
    save_checkpoint(str(run_dir), 7, model.sequence)
    with open(run_dir / "flags.json", "w") as f:
        json.dump(dict(FLAGS, model_config="sqair_tpu/configs/pedestrian_model.py"), f)
    npz = tmp_path / "valid.npz"
    np.savez(npz, imgs=np.round(obs * 255).astype(np.uint8), nums=nums)
    argv = ["--checkpoint_dir", str(run_dir), "--data_npz", str(npz), "--eval_batch_size",
            str(B), "--device", "cpu"]
    with pytest.raises(RuntimeError, match="size mismatch"):
        port_eval.main(argv + ["--model_config", "sqair_tpu/configs/mlp_mnist_model.py"])
    assert port_eval.main(argv) == [7]
    with open(run_dir / "logpx_valid.txt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and lines[0].startswith("7:")
    assert np.isfinite(float(lines[0].split(":")[1]))
