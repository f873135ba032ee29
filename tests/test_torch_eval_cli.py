"""The port's checkpoints and its checkpoint-sweep eval CLI
(sqair_tpu_torch/training/checkpoint.py, sqair_tpu_torch/scripts/eval.py)
and the converter tools/jax_ckpt_to_torch.py.

- The release checkpoint (release_models/mnist_mlp/1), converted, swept by
  the port on the CPU over the 256-sequence font valid set of its
  flags.json (font bank of 256 glyphs of 28 px from seed 0, valid seed 1,
  T=10), in the JAX script's batch order and with its PRNGKey(1) noise
  replayed for every batch, writes the nine metric files that the JAX
  package wrote into the release dir: held at 1e-4 on |a - b| / (|b| + 1)
  (f32 on both sides; eight batches of the whole model at release width).
- A second sweep skips the step it has done.
- A train state saved and restored is bit-identical, and so is the step
  after it.
- The converter carries an optax RMSProp state (nu, trace, count) over
  exactly.
"""
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sqair_tpu.training import save_checkpoint as jax_save_checkpoint
from sqair_tpu.training.train import make_lr_schedule as jax_lr_schedule
from sqair_tpu.training.train import make_optimizer as jax_make_optimizer
from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.data import create_seq_dataset, make_font_digit_bank
from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
from sqair_tpu_torch.scripts import eval as port_eval
from sqair_tpu_torch.training import make_train_step
from sqair_tpu_torch.training.checkpoint import (find_checkpoints, load_checkpoint,
                                                 restore_train_state, save_checkpoint)
from torch_parity import H, assert_close, golden_batch, jax_noise_table
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = os.path.join(REPO, "release_models", "mnist_mlp", "1")
sys.path.insert(0, os.path.join(REPO, "tools"))
import jax_ckpt_to_torch  # noqa: E402

TOL = 1e-4
SMALL = dict(n_units=1, n_what=8, n_steps_per_image=2, glimpse_size=8, k_particles=2,
             early_disc_logit_scale=0.15, transient_disc_penalty=2.0, learning_rate=1e-4)


def _read_metric_file(path):
    with open(path) as f:
        lines = [line for line in f.read().splitlines() if line.strip()]
    return [(int(line.split(":")[0]), np.array(line.split(":")[1].split(), np.float64))
            for line in lines]


def _font_valid_npz(path, flags):
    bank, _ = make_font_digit_bank(flags["font_bank_size"], flags["font_obj_size"],
                                   seed=flags["font_seed"])
    obj = (flags["font_obj_size"],) * 2
    data = create_seq_dataset(n_samples=flags["font_valid_samples"],
                              n_timesteps=flags["font_timesteps"], obj_size=obj,
                              seed=flags["font_seed"] + 1, templates=bank)
    np.savez(path, imgs=data["imgs"], nums=data["nums"])


def test_release_checkpoint_sweep_reproduces_the_release_metrics(tmp_path):
    with open(os.path.join(RELEASE, "flags.json")) as f:
        flags = json.load(f)
    run_dir = str(tmp_path / "run" / "1")
    jax_ckpt_to_torch.main(["--checkpoint", os.path.join(RELEASE, "ckpt-1000000"),
                            "--out_dir", run_dir])
    assert sorted(find_checkpoints(run_dir)) == [1000000]
    assert "optimizer" not in load_checkpoint(os.path.join(run_dir, "ckpt-1000000"))
    npz = str(tmp_path / "valid.npz")
    _font_valid_npz(npz, flags)

    # as main() does, with JAX's PRNGKey(1) noise in place of the port's own
    args, overrides = port_eval.parse_args(["--checkpoint_dir", run_dir, "--data_npz", npz,
                                            "--device", "cpu"])
    imgs, nums = port_eval.load_npz(npz)
    batcher = port_eval.eval_batcher(imgs, nums, args.eval_batch_size)
    next(batcher)
    model = mlp_mnist_model.load(port_eval.run_flags(run_dir, overrides), imgs.shape[2:],
                                 mean_img=np.zeros(imgs.shape[2:]), device="cpu")
    k, S = flags["k_particles"], flags["n_steps_per_image"]
    table = jax_noise_table(jax.random.PRNGKey(port_eval.NOISE_SEED), imgs.shape[0], S,
                            args.eval_batch_size * k, flags["n_what"])
    done = port_eval.sweep(run_dir, model, batcher, imgs.shape[1] // args.eval_batch_size,
                           noise=lambda: ReplayNoise(table, "cpu"))
    assert done == [1000000]

    for metric in port_eval.METRICS:
        name = f"{port_eval.METRIC_FILES[metric]}_valid.txt"
        got = _read_metric_file(os.path.join(run_dir, name))
        want = _read_metric_file(os.path.join(RELEASE, name))
        assert [s for s, _ in got] == [s for s, _ in want] == [1000000], name
        assert_close(got[0][1], want[0][1], TOL, name)

    # the CLI on the same run dir resumes: the step is in the iwae file
    assert port_eval.main(["--checkpoint_dir", run_dir, "--data_npz", npz,
                           "--device", "cpu"]) == []
    assert len(_read_metric_file(os.path.join(run_dir, "logpx_valid.txt"))) == 1


def test_eval_cli_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    npz = str(tmp_path / "d.npz")
    np.savez(npz, imgs=np.zeros((2, 4, 24, 24), np.uint8), nums=np.zeros((1, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_eval.main(["--checkpoint_dir", str(tmp_path), "--data_npz", npz])


def test_command_line_model_flags_win_over_flags_json(tmp_path):
    with open(tmp_path / "flags.json", "w") as f:
        json.dump(dict(n_units=8, early_disc_logit_clamp=0.5, eval_batch_size=7), f)
    args, overrides = port_eval.parse_args(
        ["--checkpoint_dir", str(tmp_path), "--data_npz", "x.npz", "--eval_batch_size", "16",
         "--early_disc_logit_clamp", "0", "--masked_glimpse=false"])
    flags = port_eval.run_flags(str(tmp_path), overrides)
    assert args.eval_batch_size == 16 and args.device == "cuda"
    assert flags == dict(n_units=8, early_disc_logit_clamp=0, masked_glimpse=False)


def _train_pair():
    model = mlp_mnist_model.load(SMALL, (H, H), device="cpu", seed=0)
    optimizer, l2 = mlp_mnist_model.make_optimizer(SMALL)
    return model, make_train_step(model, optimizer, l2_weight=l2)


def test_train_state_round_trip_is_bit_identical(tmp_path):
    obs, nums = golden_batch()
    model, step = _train_pair()
    for i in range(2):
        step(obs, nums, GeneratorNoise(torch.Generator().manual_seed(i), "cpu"))
    path = save_checkpoint(str(tmp_path), step.state.step, model.sequence,
                           step.state.optimizer)
    assert os.path.basename(path) == "ckpt-2"
    fresh, fresh_step = _train_pair()
    restore_train_state(path, fresh.sequence, fresh_step.state)
    assert fresh_step.state.step == 2 and fresh_step.state.optimizer.count == 2
    for (name, a), b in zip(model.sequence.state_dict().items(),
                            fresh.sequence.state_dict().values()):
        assert torch.equal(a, b), name
    names = dict(model.sequence.named_parameters())
    fresh_names = dict(fresh.sequence.named_parameters())
    opt, fresh_opt = step.state.optimizer, fresh_step.state.optimizer
    assert len(opt.state) == len(fresh_opt.state) == len(names) - 2  # not the decoder stds
    for name, p in names.items():
        for key in opt.state.get(p, {}):
            assert torch.equal(opt.state[p][key], fresh_opt.state[fresh_names[name]][key])
    # the next step is the same on both
    for s in (step, fresh_step):
        s(obs, nums, GeneratorNoise(torch.Generator().manual_seed(9), "cpu"))
    for (name, a), b in zip(model.sequence.state_dict().items(),
                            fresh.sequence.state_dict().values()):
        assert torch.equal(a, b), name


def test_converter_carries_the_optax_state(tmp_path):
    """An orbax checkpoint with params, the optax RMSProp state after one
    update and the step converts into the port's format exactly."""
    model = mlp_mnist_model.load(SMALL, (H, H), mean_img=np.full((H, H), 0.1, np.float32),
                                 device="cpu", seed=3)
    tree = jax_ckpt_to_torch.flax_tree_like(model.sequence)
    rs = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda z: jnp.asarray(rs.normal(size=z.shape).astype(np.float32)), tree)
    grads = jax.tree_util.tree_map(
        lambda z: jnp.asarray(rs.normal(size=z.shape).astype(np.float32)), tree)
    flags = dict(SMALL, schedule="4,6,10", train_itr=100, opt="rmsprop")
    opt = jax_make_optimizer("rmsprop", jax_lr_schedule(1e-4, "4,6,10", 100))
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    src = tmp_path / "jax" / "1"
    jax_save_checkpoint(str(src), 7, dict(params=params, opt_state=state, step=np.asarray(7)))
    with open(src / "flags.json", "w") as f:
        json.dump(flags, f)
    out = tmp_path / "torch" / "1"
    jax_ckpt_to_torch.main(["--checkpoint", str(src / "ckpt-7"), "--out_dir", str(out),
                            "--img_size", f"{H},{H}"])
    assert (out / "flags.json").exists()
    ckpt = load_checkpoint(str(out / "ckpt-7"))
    assert ckpt["step"] == 7 and ckpt["optimizer"]["count"] == 1
    from sqair_tpu_torch.convert import params_from_flax

    def flat(t):
        return params_from_flax(jax.tree_util.tree_map(np.asarray, t))

    for key, want in flat(params).items():
        assert torch.equal(ckpt["params"][key], want), key
    for key, want in flat(state[0].nu).items():
        assert torch.equal(ckpt["optimizer"]["nu"][key], want), key
    for key, want in flat(state[2].trace).items():
        assert torch.equal(ckpt["optimizer"]["trace"][key], want), key
    shutil.rmtree(src)
