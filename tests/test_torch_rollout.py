"""The port's rollout script (python -m sqair_tpu_torch.scripts.rollout)
held to the JAX package's (sqair_tpu.scripts.rollout) at the cases of
tests/test_configs_rollout.py: the small-digit configs, the pedestrian
configs' non-square 40x30 frames and 16x6 glimpses, and a rollout of 9
frames past a 3-frame dataset.  Each case runs, in an interpreter of its
own (the configs' retunes of flag defaults hold for a whole process), JAX's
script with fresh weights, converts them into a checkpoint of the port with JAX's resolved
flags as its flags.json, and runs the port's script on it on the CPU with
JAX's noise replayed (``fold_in(PRNGKey(rollout_seed), 1)``, the prior
samples included).  rollout.npz's fields are held at 1e-4 on
|a - b| / (|b| + 1) (f32 on both sides), ``conditioned`` exactly; frames
from the first presence draw within chip_smoke.FLIP_MARGIN of its
probability on are not gated (``torch_parity.near_tie_frame``).  A second
test holds the port's flag precedence (flags.json under the rollout's own
flags, the configs from the command line where given) to the JAX script's.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sqair_tpu.experiment import experiment_tools as jtools
from sqair_tpu.experiment import flags as jflags
from sqair_tpu.models import Model as JModel
from sqair_tpu.scripts import rollout as jrollout
from sqair_tpu_torch.convert import params_from_flax
from sqair_tpu_torch.experiment import flags as pflags
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.scripts import rollout as prollout
from sqair_tpu_torch.training.checkpoint import save_checkpoint
from torch_parity import assert_close, jax_noise_table, near_tie_frame, to_numpy
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

TOL = 1e-4
TINY = ["--n_steps_per_image=2", "--k_particles=2", "--n_units=1", "--n_what=4"]
COMMON = ["--rollout_len=4", "--condition_frames=2", "--n_examples=2"]
PED = ["--ped_train_samples=8", "--ped_valid_samples=4", "--ped_timesteps=3",
       "--ped_canvas=40,30", "--glimpse_hw=16,6",
       "--data_config=sqair_tpu/configs/pedestrian_data.py",
       "--model_config=sqair_tpu/configs/pedestrian_model.py"]
CASES = {
    "small_digits": (["--font_train_samples=8", "--font_valid_samples=4", "--font_timesteps=3",
                      "--font_bank_size=8",
                      "--data_config=sqair_tpu/configs/small_digit_seq_mnist_data.py",
                      "--model_config=sqair_tpu/configs/small_digit_mnist_model.py"],
                     (4, 2, 50, 50)),
    "pedestrian": (PED, (4, 2, 40, 30)),
    "beyond_the_data": (PED + ["--rollout_len=9"], (9, 2, 40, 30)),
}
FIELDS = ("canvas", "where", "presence", "obj_id")


class _Stop(Exception):
    pass


def _jax_main(argv, patches=()):
    """JAX's script in this process, its flag registry put back after; returns
    the flags it ran with."""
    saved = dict(jflags.FLAGS._values), set(jflags.FLAGS._cli_set), sys.argv
    try:
        with pytest.MonkeyPatch.context() as mp:
            for obj, name, fn in patches:
                mp.setattr(obj, name, fn)
            try:
                jrollout.main(argv)
            except _Stop:
                pass
        return dict(jflags.FLAGS._values)
    finally:
        jflags.FLAGS._values.clear()
        jflags.FLAGS._values.update(saved[0])
        jflags.FLAGS._cli_set.clear()
        jflags.FLAGS._cli_set.update(saved[1])
        sys.argv = saved[2]


def _port(fn, *args, **kwargs):
    """The port's script in this process, from a clean registry."""
    saved = sys.argv
    pflags.reset()
    try:
        return fn(*args, **kwargs)
    finally:
        sys.argv = saved
        pflags.reset()


def run_case(case, root):
    """Both scripts on one case in this interpreter (a fresh one: the
    configs' retunes hold for a whole process); writes root/jax/rollout.npz,
    root/port/rollout.npz and root/port/result.json."""
    torch.set_num_threads(1)
    extra, shape = CASES[case]
    argv = TINY + COMMON + extra
    # the configs' flags defined before JAX's script parses its command line
    # (as tests/test_configs_rollout.py imports them)
    for arg in ("--model_config=", "--data_config="):
        jtools._import_module(next(a for a in extra if a.startswith(arg))[len(arg):])
    inits = []
    real_init = JModel.init

    def init(self, rng, obs):
        inits.append(real_init(self, rng, obs))
        return inits[-1]

    used = _jax_main(argv + [f"--out_dir={root}/jax"], [(JModel, "init", init)])

    run_dir = os.path.join(root, "run", "1")
    flat = params_from_flax(to_numpy(inits[0]))
    save_checkpoint(run_dir, 0, types.SimpleNamespace(state_dict=lambda: flat))
    with open(os.path.join(run_dir, "flags.json"), "w") as f:
        json.dump(used, f)
    T, B = shape[:2]
    k, S = used["k_particles"], used["n_steps_per_image"]
    table = jax_noise_table(jax.random.fold_in(jax.random.PRNGKey(0), 1), T, S, B * k,
                            used["n_what"], prior=True, rec_where_prior=used["rec_where_prior"])
    sites = {}
    real_generate = prollout.generate

    def generate(model, obs, noise):
        with chip_smoke.presence_sites(torch, model) as s:
            out = real_generate(model, obs, noise)
        sites.update(s)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prollout, "generate", generate)
        result = _port(prollout.main, argv + [f"--checkpoint_dir={run_dir}",
                                              f"--out_dir={root}/port", "--device=cpu"],
                       noise=ReplayNoise(table, "cpu"))
    with open(os.path.join(root, "port", "result.json"), "w") as f:
        json.dump(dict(near_tie_frame=near_tie_frame(sites, table),
                       png=result["png"],
                       generated_disc_pres=float(result["outputs"]["disc_pres"][2:].abs().max())),
                  f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_matches_jax(case, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    subprocess.run([sys.executable, __file__, case, str(tmp_path)], check=True, cwd=REPO,
                   env=env, timeout=600)
    want = np.load(tmp_path / "jax" / "rollout.npz")
    got = np.load(tmp_path / "port" / "rollout.npz")
    with open(tmp_path / "port" / "result.json") as f:
        result = json.load(f)
    shape = CASES[case][1]
    assert sorted(got.files) == sorted(want.files) == sorted(FIELDS + ("conditioned",))
    assert got["canvas"].shape == want["canvas"].shape == shape
    np.testing.assert_array_equal(got["conditioned"], want["conditioned"])
    gated = result["near_tie_frame"]
    gated = shape[0] if gated is None else gated
    assert gated > 2, f"only frames [0, {gated}) gated"
    for name in FIELDS:
        assert got[name].shape == want[name].shape, name
        assert_close(got[name][:gated], want[name][:gated], TOL, name)
    assert np.isfinite(got["canvas"]).all()
    assert result["png"] == str(tmp_path / "port" / "rollout.png")
    assert os.path.exists(result["png"])
    # discovery's presence is 0 in every generated frame
    assert result["generated_disc_pres"] == 0.0


def test_flag_precedence_matches_jax(tmp_path):
    """flags.json wins over a model flag on the command line; the rollout's
    own flags (and --device) and a config given on the command line win
    over flags.json."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    saved = dict(n_units=3, n_what=6, output_std=0.2, rollout_len=50, n_examples=7,
                 data_config="sqair_tpu/configs/font_seq_mnist_data.py",
                 model_config="sqair_tpu/configs/mlp_mnist_model.py", device="cuda")
    with open(run_dir / "flags.json", "w") as f:
        json.dump(saved, f)
    names = ("n_units", "n_what", "output_std", "rollout_len", "n_examples", "data_config",
             "model_config", "condition_frames")

    def stop(*args, **kwargs):
        raise _Stop

    for extra in ([], ["--data_config=sqair_tpu/configs/synth_seq_mnist_data.py"]):
        argv = [f"--checkpoint_dir={run_dir}", "--n_units=1", "--rollout_len=9",
                "--condition_frames=3"] + extra
        want = _jax_main(argv, [(jrollout, "load", stop)])
        got = _port(prollout.resolve_flags, argv + ["--device=cpu"])
        assert {n: got[n] for n in names} == {n: want[n] for n in names}, extra
        assert got["device"] == "cpu"
        assert got["n_units"] == 3 and got["rollout_len"] == 9


if __name__ == "__main__":
    run_case(sys.argv[1], sys.argv[2])
