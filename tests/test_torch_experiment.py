"""The port's training CLI (python -m sqair_tpu_torch.scripts.experiment) on
the CPU, and the whole slice held to the JAX package's CLI.

- ``--test_run`` end to end: the run dir, flags.json, metrics.jsonl with
  the JAX package's heartbeat and eval keys, the checkpoint.
- ``--steps_per_call 2`` against 1, and a run saved at step 10 and resumed
  to 20 against the uninterrupted one: the same bits (parameters, the
  optimizer's state, the generators, heartbeats and evals).
- The cadence and alignment errors, with the JAX CLI's messages.
- Against JAX: both CLIs on the host-batch path at the test-run widths
  (B=8, k=2, T=2, 128 wide), JAX's step-0 weights carried over (its
  checkpoint at step 0 converted by tools/jax_ckpt_to_torch.py, then
  ``--resume``), JAX's noise (``fold_in(PRNGKey(0), itr)`` for the train
  steps, PRNGKey(1) for the evals) replayed through the CLI's noise hooks
  and JAX's TPU kernels interpreted (the port's backward follows them at
  elu'(0)).  Tolerances: the step-0 eval metrics 1e-4 on |a - b| / (|b| + 1)
  (tests/test_torch_eval_step.py's, for the same reason); the parameters
  after each of 2 steps tests/test_torch_train_step.py's per-step bound,
  sum_j lr_j EPS max|g_j| / sqrt(0.9) w_ij + 4 f32 ulps of the largest
  element, with g_j read off JAX's optimizer state.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from sqair_tpu.experiment import flags as jflags
from sqair_tpu.scripts import experiment as jexp
from sqair_tpu_torch import eval_tools
from sqair_tpu_torch.experiment import flags as pflags
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.scripts import experiment as pexp
from sqair_tpu_torch.training import make_lr_schedule
from torch_parity import jax_noise_table, tpu_kernels_interpreted
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import jax_ckpt_to_torch  # noqa: E402

HEARTBEAT = {"step", "target", "iwae", "num_steps", "num_step_acc", "seq_len",
             "frames_per_sec"}
# the test-run widths, spelled out (--test_run fixes train_itr and the cadences)
WIDTHS = ["--data_config=sqair_tpu/configs/synth_seq_mnist_data.py",
          "--model_config=sqair_tpu/configs/mlp_mnist_model.py", "--seq_len=2",
          "--eval_on_train=false", "--batch_size=8", "--k_particles=2", "--n_units=4",
          "--synth_train_samples=64", "--synth_valid_samples=32", "--synth_timesteps=3"]
SHORT = WIDTHS + ["--report_loss_every=10", "--log_itr=20", "--fig_itr=20", "--device=cpu",
                  "--on_device_data"]
METRIC_TOL = 1e-4
EPS = 3e-4  # tests/test_torch_train_step.py: gradient agreement per step
B, K, T, S, NWHAT = 8, 2, 2, 3, 50


def _main(argv, **hooks):
    """The port's CLI in this process, from a clean registry."""
    saved = sys.argv
    pflags.reset()
    try:
        return pexp.main(argv, **hooks)
    finally:
        sys.argv = saved
        pflags.reset()


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpt(run_dir, step):
    return torch.load(os.path.join(run_dir, f"ckpt-{step}"), weights_only=True)


def _same_tree(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same_tree(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _without_rates(records):
    return [{k: v for k, v in r.items() if k != "frames_per_sec"} for r in records]


class _Killed(Exception):
    pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four short runs of 20 steps on the device sampler: one step a call,
    two a call, and two a call killed right after its save at step 10,
    then resumed."""
    root = str(tmp_path_factory.mktemp("runs"))
    out = {}
    for name, steps in (("one", 1), ("two", 2)):
        out[name] = _main(SHORT + [f"--steps_per_call={steps}", "--train_itr=20", "--save_itr=10",
                                   f"--results_dir={root}", f"--run_name={name}"])[0]

    def save_then_die(run_dir, step, *args, **kwargs):
        save_checkpoint(run_dir, step, *args, **kwargs)
        if step == 10:
            raise _Killed

    save_checkpoint = pexp.save_checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pexp, "save_checkpoint", save_then_die)
        with pytest.raises(_Killed):
            _main(SHORT + ["--steps_per_call=2", "--train_itr=20", "--save_itr=10",
                           f"--results_dir={root}", "--run_name=cut"])
    out["cut"] = os.path.join(root, "cut", "1")
    out["resumed"] = _main([f"--results_dir={root}", "--run_name=cut", "--resume"])[0]
    return out


def test_test_run_end_to_end(tmp_path):
    logdir, model, state = _main(["--test_run", "--device=cpu", f"--results_dir={tmp_path}"])
    assert logdir == str(tmp_path / "mnist_test" / "1") and state.step == 200
    # the figures at the start, every fig_itr (100) and the end, where
    # matplotlib is installed
    figures = [f"{kind}_fig_{itr}.png" for kind in ("still", "seq") for itr in (0, 100, 200)
               if eval_tools._HAS_MPL]
    assert sorted(os.listdir(logdir)) == sorted(
        ["flags.json", "metrics.jsonl", "ckpt-200", "mlp_mnist_model.py",
         "synth_seq_mnist_data.py"] + figures
        + [f for f in os.listdir(logdir) if f.startswith("events")])
    with open(os.path.join(logdir, "flags.json")) as f:
        flags = json.load(f)
    assert flags["test_run"] is True and flags["n_units"] == 4 and flags["train_itr"] == 200
    records = _records(logdir)
    heartbeats = [r for r in records if "target" in r]
    assert [r["step"] for r in heartbeats] == list(range(10, 201, 10))
    assert all(set(r) == HEARTBEAT and np.isfinite(list(r.values())).all() for r in heartbeats)
    evals = [r for r in records if "iwae/test" in r]
    assert [r["step"] for r in evals] == [0, 100, 200]
    assert {"num_step_accuracy/test", "num_step_acc_per_t0/test", "target/test"} <= set(evals[0])
    ckpt = _ckpt(logdir, 200)
    assert ckpt["step"] == 200 and ckpt["optimizer"]["count"] == 200
    for name, p in model.sequence.state_dict().items():
        assert torch.equal(ckpt["params"][name], p), name


def test_steps_per_call_two_trains_the_same_model(runs):
    _same_tree(_ckpt(runs["two"], 20), _ckpt(runs["one"], 20), "ckpt-20")
    assert _without_rates(_records(runs["two"])) == _without_rates(_records(runs["one"]))


def test_resume_continues_bit_identically(runs):
    assert runs["resumed"] == runs["cut"]
    _same_tree(_ckpt(runs["resumed"], 20), _ckpt(runs["one"], 20), "ckpt-20")
    uninterrupted = [r for r in _without_rates(_records(runs["one"])) if r["step"] > 10]
    resumed = [r for r in _without_rates(_records(runs["resumed"])) if r["step"] > 10]
    assert resumed == uninterrupted and resumed


@pytest.mark.parametrize("extra, error, message", [
    (["--steps_per_call=2", "--report_loss_every=5"], ValueError,
     "--report_loss_every=5 must be divisible by --steps_per_call=2"),
    (["--steps_per_call=5", "--train_itr=12"], ValueError,
     "--train_itr=12 must be divisible by --steps_per_call=5"),
    (["--steps_per_call=2", "--seq_len=1", "--stage_itr=3"], ValueError,
     "stage_itr=3 must be divisible by --steps_per_call=2"),
    (["--on_device_data=false", "--steps_per_call=2"], ValueError,
     "--steps_per_call > 1 requires --on_device_data"),
    (["--coordinator_address=localhost:1234", "--num_processes=2", "--process_id=2"],
     ValueError, "process_id 2 is not one of the 2 processes"),
    (["--coverage_lr_mult=2"], ValueError, "--coverage_lr_mult requires --disc_coverage_signal"),
])
def test_misaligned_cadences_and_unported_flags_raise(tmp_path, extra, error, message):
    with pytest.raises(error, match=message.replace("+", r"\+")):
        _main(SHORT + ["--train_itr=20", "--save_itr=20", f"--results_dir={tmp_path}"] + extra)


def test_resumed_step_must_align_and_cuda_must_exist(tmp_path, runs):
    with pytest.raises(ValueError, match="resumed step 20 is not aligned to --steps_per_call=3"):
        _main([f"--results_dir={os.path.dirname(os.path.dirname(runs['cut']))}",
               "--run_name=cut", "--resume", "--steps_per_call=3", "--train_itr=60",
               "--report_loss_every=30", "--log_itr=60", "--fig_itr=60", "--save_itr=60"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _main(SHORT[:-2] + ["--device=cuda", f"--results_dir={tmp_path}"])


class _NoFigures:
    def __init__(self, *args, **kwargs):
        pass

    def plot_all(self, *args, **kwargs):
        pass


def _jax_main(argv):
    """The JAX package's CLI in this process, its registry put back after."""
    saved = dict(jflags.FLAGS._values), set(jflags.FLAGS._cli_set), sys.argv
    try:
        jexp.main(argv)
    finally:
        jflags.FLAGS._values.clear()
        jflags.FLAGS._values.update(saved[0])
        jflags.FLAGS._cli_set.clear()
        jflags.FLAGS._cli_set.update(saved[1])
        sys.argv = saved[2]


def test_cli_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SQAIR_NO_COMPILE_CACHE", "1")
    # no figures from JAX (tests/test_torch_render.py holds the port's to JAX's)
    monkeypatch.setattr(jexp, "ProgressFig", _NoFigures)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    # one device: the test session's JAX has eight CPU devices (conftest.py),
    # over which the JAX CLI would shard the batch
    common = WIDTHS + ["--learning_rate=1e-4", "--report_loss_every=1", "--log_itr=1000",
                       "--fig_itr=1000", "--save_itr=1", "--run_name=r", "--data_parallel=false"]
    with tpu_kernels_interpreted():
        _jax_main(common + [f"--results_dir={jroot}", "--train_itr=0"])
        _jax_main([f"--results_dir={jroot}", "--run_name=r", "--resume", "--train_itr=2"])
    jdir, pdir = os.path.join(jroot, "r", "1"), os.path.join(proot, "r", "1")
    with open(os.path.join(jdir, "flags.json")) as f:
        flags = json.load(f)
    jax_ckpt_to_torch.main(["--checkpoint", os.path.join(jdir, "ckpt-0"), "--out_dir", pdir])

    def train_noise(itr):
        rng = jax.random.fold_in(jax.random.PRNGKey(0), itr)
        return ReplayNoise(jax_noise_table(rng, T, S, B * K, NWHAT), "cpu")

    eval_table = jax_noise_table(jax.random.PRNGKey(1), T, S, B * K, NWHAT)
    _main([f"--results_dir={proot}", "--run_name=r", "--resume", "--train_itr=2",
           "--device=cpu"], train_noise=train_noise,
          eval_noise=lambda: ReplayNoise(eval_table, "cpu"))

    want = [r for r in _records(jdir) if r["step"] == 0 and "iwae/test" in r][0]
    got = [r for r in _records(pdir) if r["step"] == 0 and "iwae/test" in r][0]
    assert got.keys() == want.keys()
    for k in want:
        err = abs(got[k] - want[k]) / (abs(want[k]) + 1.0)
        assert err <= METRIC_TOL, f"step-0 eval {k}: {err:.3g}"

    rate = make_lr_schedule(1e-4, flags["schedule"], 2)
    trace_prev, step_bounds = {}, {}
    for i in (1, 2):
        conv = str(tmp_path / f"conv{i}")
        jax_ckpt_to_torch.main(["--checkpoint", os.path.join(jdir, f"ckpt-{i}"),
                                "--out_dir", conv, "--flags", os.path.join(jdir, "flags.json")])
        jstate, pstate = _ckpt(conv, i), _ckpt(pdir, i)
        weights = [sum(0.9**m for m in range(i - j)) for j in range(i)]
        for name, w in jstate["params"].items():
            w = w.numpy().astype(np.float64)
            if name in jstate["optimizer"]["trace"]:
                m_i = jstate["optimizer"]["trace"][name].numpy().astype(np.float64)
                nu = jstate["optimizer"]["nu"][name].numpy().astype(np.float64)
                u_i = m_i - 0.9 * trace_prev.get(name, 0.0)
                trace_prev[name] = m_i
                g = -u_i * np.sqrt(nu + 1e-10) / rate(i - 1)
                step_bounds.setdefault(name, []).append(
                    rate(i - 1) * EPS * float(np.max(np.abs(g), initial=0)) / np.sqrt(0.9))
            tol = sum(b * wt for b, wt in zip(step_bounds.get(name, []), weights))
            tol += 4 * np.finfo(np.float32).eps * float(np.max(np.abs(w), initial=0))
            err = float(np.max(np.abs(pstate["params"][name].numpy() - w), initial=0))
            assert err <= tol, f"step {i} {name}: {err:.3g} > {tol:.3g}"
