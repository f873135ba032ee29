"""The port's training CLI as two processes on the CPU (gloo), at the
test-run widths (B 8, k 2, T 2, 128 wide), on the device-resident sampler
(whose generator each checkpoint holds):

- one run dir, made by process 0: flags.json, the checkpoints and the
  figures are its; process 1 writes its records to ``proc1/`` alone, and
  they are process 0's (the metrics are the processes' means);
- a run killed right after its save at step 10 (process 0 dies, process 1
  is stopped), then resumed (without ``--device``: the run's own, the CPU,
  picks gloo), ends bit-identical to an uninterrupted one: parameters,
  optimizer state, every process's generator, records;
- a SIGTERM to process 1 stops both processes at the same iteration N,
  ckpt-N exists, and ``--resume`` goes on to N + 10;
- ``--steps_per_call 2`` raises in both processes.
"""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = ["--data_config=sqair_tpu/configs/synth_seq_mnist_data.py",
          "--model_config=sqair_tpu/configs/mlp_mnist_model.py", "--seq_len=2",
          "--eval_on_train=false", "--batch_size=8", "--k_particles=2", "--n_units=4",
          "--synth_train_samples=64", "--synth_valid_samples=32", "--synth_timesteps=3",
          "--device=cpu", "--on_device_data"]
SHORT = WIDTHS + ["--report_loss_every=5", "--log_itr=10", "--fig_itr=20", "--save_itr=10",
                  "--train_itr=20"]
# process 0 dies right after it has written ckpt-10
DIE_AFTER_SAVE = """
import os
from sqair_tpu_torch.scripts import experiment
real = experiment.save_checkpoint
def save_then_die(run_dir, step, *args, **kwargs):
    path = real(run_dir, step, *args, **kwargs)
    if step == 10:
        os._exit(3)
    return path
experiment.save_checkpoint = save_then_die
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, name, argv, prefix=("", "")):
    """Two CLI processes; returns (processes, log paths)."""
    port = _free_port()
    procs, logs = [], []
    for r in (0, 1):
        args = argv + [f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
                       f"--process_id={r}"]
        code = (prefix[r] + "\nfrom sqair_tpu_torch.scripts import experiment\n"
                f"experiment.main({args!r})\n")
        log = str(tmp / f"{name}.{r}.log")
        with open(log, "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=f,
                                          stderr=subprocess.STDOUT,
                                          env=dict(os.environ, OMP_NUM_THREADS="1")))
        logs.append(log)
    return procs, logs


def _wait(procs, logs, timeout=600):
    rcs = [p.wait(timeout=timeout) for p in procs]
    return rcs, [open(log).read() for log in logs]


def _run(tmp, name, argv, prefix=("", "")):
    rcs, out = _wait(*_launch(tmp, name, argv, prefix))
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in out)
    return out


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "frames_per_sec"}
                for line in f]


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


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("mp")


@pytest.fixture(scope="module")
def whole(root):
    """An uninterrupted two-process run of 20 steps."""
    _run(root, "whole", SHORT + [f"--results_dir={root}", "--run_name=whole"])
    return os.path.join(root, "whole", "1")


def test_one_run_dir_and_one_writer(whole):
    assert sorted(os.listdir(os.path.dirname(whole))) == ["1"]
    names = set(os.listdir(whole))
    assert {"flags.json", "metrics.jsonl", "ckpt-10", "ckpt-20", "proc1"} <= names
    assert os.listdir(os.path.join(whole, "proc1")) == ["metrics.jsonl"]
    assert not any(n.startswith(".ckpt-") for n in names)
    ours, theirs = (_records(os.path.join(d, "metrics.jsonl"))
                    for d in (whole, os.path.join(whole, "proc1")))
    assert [r["step"] for r in ours] == [0, 5, 10, 10, 15, 20, 20]
    assert ours == theirs
    ckpt = _ckpt(whole, 20)
    assert sorted(ckpt["rng"]) == ["data", "noise", "noise_rank1"]
    assert not torch.equal(ckpt["rng"]["noise"], ckpt["rng"]["noise_rank1"])
    flags = json.load(open(os.path.join(whole, "flags.json")))
    assert flags["num_processes"] == 2 and flags["process_id"] == 0


def test_killed_then_resumed_is_bit_identical(root, whole):
    argv = SHORT + [f"--results_dir={root}", "--run_name=cut"]
    procs, logs = _launch(root, "cut", argv, prefix=(DIE_AFTER_SAVE, ""))
    assert procs[0].wait(timeout=600) == 3
    try:  # process 1 waits for its peer at the checkpoint's barrier, or fails there
        procs[1].wait(timeout=60)
    except subprocess.TimeoutExpired:
        procs[1].kill()
        procs[1].wait()
    run_dir = os.path.join(root, "cut", "1")
    assert sorted(n for n in os.listdir(run_dir) if n.startswith("ckpt-")) == ["ckpt-10"]
    flags_before = open(os.path.join(run_dir, "flags.json")).read()
    _run(root, "resumed", [f"--results_dir={root}", "--run_name=cut", "--resume"])
    # a resume that changes nothing the run computes leaves flags.json alone
    assert open(os.path.join(run_dir, "flags.json")).read() == flags_before
    _same_tree(_ckpt(run_dir, 20), _ckpt(whole, 20), "ckpt-20")
    for sub in ("", "proc1"):
        got = [r for r in _records(os.path.join(run_dir, sub, "metrics.jsonl"))
               if r["step"] > 10]
        want = [r for r in _records(os.path.join(whole, sub, "metrics.jsonl"))
                if r["step"] > 10]
        assert got == want, sub


def test_sigterm_to_one_process_stops_both_at_one_iteration(root):
    argv = WIDTHS + [f"--results_dir={root}", "--run_name=preempt", "--train_itr=100000",
                     "--report_loss_every=5", "--save_itr=50000", "--log_itr=50000",
                     "--fig_itr=50000"]
    procs, logs = _launch(root, "preempt", argv)
    deadline = time.time() + 300
    while not re.search(r"^5: target=", open(logs[0]).read(), re.M):
        assert time.time() < deadline and all(p.poll() is None for p in procs), \
            open(logs[0]).read()[-3000:]
        time.sleep(0.5)
    procs[1].send_signal(signal.SIGTERM)
    rcs, out = _wait(procs, logs)
    assert rcs == [0, 0], "\n".join(o[-3000:] for o in out)
    stops = [re.findall(r"coordinated stop .* stopping at iter (\d+)", o) for o in out]
    assert len(stops[0]) == 1 and stops[0] == stops[1], stops
    n = int(stops[0][0])
    run_dir = os.path.join(root, "preempt", "1")
    assert os.path.exists(os.path.join(run_dir, f"ckpt-{n}"))
    _run(root, "preempt_resumed", [f"--results_dir={root}", "--run_name=preempt", "--resume",
                                   "--device=cpu", f"--train_itr={n + 10}"])
    assert _ckpt(run_dir, n + 10)["step"] == n + 10


def test_steps_per_call_over_one_raises(root):
    rcs, out = _wait(*_launch(root, "chained", SHORT + [f"--results_dir={root}",
                                                        "--run_name=chained",
                                                        "--steps_per_call=2"]))
    assert rcs[0] != 0 and rcs[1] != 0
    for o in out:
        assert "--steps_per_call > 1 requires --on_device_data and is incompatible with the " \
               "data-parallel mesh path" in o, o[-2000:]
