"""The port's data parallelism (sqair_tpu_torch/parallel) held to the JAX
package's shard_map strategy (sqair_tpu/parallel/mesh.py), on the CPU.

The model is tests/test_parallel_fused.py's tiny one (B 8, T 2, S 2, 16x16
frames, 6x6 glimpses, k 2), its weights JAX's init, converted.  The port's
processes are gloo workers (tests/torch_dp_worker.py), each replaying the
noise of JAX's shard: ``jax_noise_table(fold_in(rng, s), ...)``.  JAX runs
its TPU kernels interpreted (``tpu_kernels_interpreted``), whose elu'(0)
the port's backward follows.

- 2 processes against JAX's ``make_parallel_train_step`` and
  ``make_parallel_eval_step`` (``use_shard_map=True``, ``make_mesh`` of two
  devices), with no aspect penalty and with 0.7 (the global ratio): the
  eval step's metrics and the train step's target, aspect and
  transient_excess within METRIC_TOL on |a - b| / (|b| + 1); the
  parameters after one RMSProp step within lr EPS max|g| / sqrt(0.9) + 4
  f32 ulps of the parameter's largest element (tests/test_torch_train_step.py's
  bound for one step: RMSProp's first step divides each gradient by at least
  sqrt(0.9));
- 2 processes against an in-process two-shard oracle (per-shard gradients,
  (g0 + g1) / 2, RMSProp; the metrics' parts averaged, then finalized):
  bit for bit, as a sum of two terms is the same in either order and
  halving is exact;
- one process against the single-process train and eval steps, bit for bit;
- a 2x2 multislice mesh (4 processes) against a flat mesh of 4, whose sums
  run in another order (parameters within lr 1e-5 max|g| / sqrt(0.9) + 4
  ulps), and against JAX's multislice step as above;
- a batch that does not split evenly raises.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import AIRDecoder as JAIRDecoder
from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.models import SQAIRTimestep as JTimestep
from sqair_tpu.parallel import make_mesh as jax_make_mesh
from sqair_tpu.parallel import make_parallel_train_step as jax_parallel_train_step
from sqair_tpu.parallel import shard_batch as jax_shard_batch
from sqair_tpu.parallel.mesh import make_multislice_mesh as jax_multislice_mesh
from sqair_tpu.parallel.mesh import make_parallel_eval_step as jax_parallel_eval_step
from sqair_tpu.training import init_train as jax_init_train
from sqair_tpu.training import make_optimizer as jax_make_optimizer
from sqair_tpu_torch.convert import load_flax_params
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.parallel import make_mesh, make_parallel_eval_step, make_parallel_train_step
from sqair_tpu_torch.parallel.mesh import Mesh, make_multislice_mesh
from sqair_tpu_torch.training import make_eval_step, make_optimizer, make_train_step
from torch_dp_worker import B, HW, NH, NWHAT, S, T, tiny_model
from torch_parity import jax_noise_table, to_numpy, tpu_kernels_interpreted
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_worker.py")
K = 2
LR = 1e-3
METRIC_TOL = 1e-4
EPS = 3e-4  # gradient agreement with JAX per step, a share of the largest |g|
REORDER_EPS = 1e-5  # the same between two orders of a sum over 4 processes
RNG_EVAL, RNG_TRAIN = 6, 5
PENALTIES = (0.0, 0.7)
COMPARED = ("target", "aspect", "transient_excess")


def _jax_model(aspect_penalty=0.0):
    ts = JTimestep(n_steps=S, img_size=(HW, HW), glimpse_size=(6, 6), n_what=NWHAT,
                   n_hidden=NH, steps_pred_hidden=[8])
    dec = JAIRDecoder(img_size=(HW, HW), glimpse_size=(6, 6), glimpse_n_hiddens=[NH],
                      mean_img=np.zeros((HW, HW), np.float32))
    return JModel(JSequentialAIR(ts, dec), k_particles=K, aspect_penalty=aspect_penalty)


def _noise(seed, world):
    """{shard: the JAX shard's noise}, as ``fold_in(PRNGKey(seed), shard)``."""
    return {s: jax_noise_table(jax.random.fold_in(jax.random.PRNGKey(seed), s), T, S,
                               B // world * K, NWHAT) for s in range(world)}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, name, world, **spec):
    """Starts ``world`` workers on ``spec``; returns a function that waits
    for them and returns each rank's output."""
    path = str(tmp / f"{name}.spec")
    torch.save(spec, path)
    out = str(tmp / f"{name}.out")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r), str(world), str(port), out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(world)]

    def wait():
        logs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"{name} rank {r}:\n{logs[r][-3000:]}"
        return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]

    return wait


def _jax_step(jmodel, jparams, obs, nums, mesh, with_eval):
    """JAX's shard_map train step (and eval step) on ``mesh``."""
    opt = jax_make_optimizer("rmsprop", LR)
    opt_state = opt.init(jparams)
    batch = jax_shard_batch({"obs": jnp.asarray(obs), "nums": jnp.asarray(nums)}, mesh)
    with tpu_kernels_interpreted():
        out = {}
        if with_eval:
            ev = jax_parallel_eval_step(jmodel, mesh, use_shard_map=True)
            out["eval"] = to_numpy(ev(jparams, jax.random.PRNGKey(RNG_EVAL), batch["obs"],
                                      batch["nums"]))
        step = jax_parallel_train_step(jmodel, opt, mesh, donate=False, use_shard_map=True)
        params, _, metrics = step(jparams, opt_state, jax.random.PRNGKey(RNG_TRAIN),
                                  batch["obs"], batch["nums"])
        out["train"], out["params"] = to_numpy(metrics), params
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' runs and JAX's steps, the workers running while JAX
    compiles."""
    tmp = tmp_path_factory.mktemp("dp")
    jmodel = _jax_model()
    rs = np.random.default_rng(1)
    obs = rs.uniform(size=(T, B, HW, HW)).astype(np.float32)
    nums = np.concatenate([np.ones((T, B, 1)), np.zeros((T, B, S))], -1).astype(np.float32)
    jparams = jax_init_train(jmodel, jax_make_optimizer("rmsprop", LR), jax.random.PRNGKey(0),
                             jnp.asarray(obs)).params
    weights = load_flax_params(tiny_model().sequence, to_numpy(jparams)).state_dict()
    common = dict(weights=weights, obs=obs, nums=nums, opt=("rmsprop", LR))
    noise2 = [_noise(RNG_EVAL, 2), _noise(RNG_TRAIN, 2)]
    noise4 = [_noise(RNG_EVAL, 4), _noise(RNG_TRAIN, 4)]
    out = dict(obs=obs, nums=nums, weights=weights, noise2=noise2, port={}, jax={})
    waits = {pen: _launch(tmp, f"pen{pen}", 2, aspect_penalty=pen, noise=noise2, **common)
             for pen in PENALTIES}
    mesh2 = jax_make_mesh(jax.devices()[:2])
    for pen in PENALTIES:
        out["jax"][pen] = _jax_step(_jax_model(pen), jparams, obs, nums, mesh2,
                                    with_eval=pen > 0)
    for pen, wait in waits.items():
        out["port"][pen] = wait()
    wait = _launch(tmp, "multislice", 4, slices=2, noise=noise4, **common)
    out["jax"]["multislice"] = _jax_step(jmodel, jparams, obs, nums,
                                         jax_multislice_mesh(2, jax.devices()[:4]), False)
    out["port"]["multislice"] = wait()
    out["port"]["flat4"] = _launch(tmp, "flat4", 4, noise=noise4, **common)()
    return out


def _assert_metrics(got, want, what):
    for key in COMPARED:
        if key not in want:
            continue
        g, w = float(got[key]), float(want[key])
        assert abs(g - w) / (abs(w) + 1.0) <= METRIC_TOL, f"{what} {key}: {g} vs {w}"


def _assert_params(got, want, grads, eps, what):
    """Each parameter within LR eps max|g| / sqrt(0.9) + 4 f32 ulps of its
    largest element (``grads``: the port's mean gradients)."""
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = got[name].numpy().astype(np.float64)
        gmax = float(grads[name].abs().max()) if name in grads else 0.0
        tol = LR * eps * gmax / np.sqrt(0.9) + 4 * np.spacing(np.float32(np.abs(w).max()))
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{what} {name}: {err:.3g} > {tol:.3g}"


def _flax_names(params):
    """{state_dict name: array} of a flax parameter tree."""
    from sqair_tpu_torch.convert import params_from_flax

    return {k: v.numpy() for k, v in params_from_flax(to_numpy(params)).items()}


@pytest.mark.parametrize("penalty", PENALTIES)
def test_two_processes_match_jax_shard_map(runs, penalty):
    port, jx = runs["port"][penalty], runs["jax"][penalty]
    for r in (0, 1):
        _assert_metrics(port[r]["train"][0], jx["train"], f"train rank {r}")
        if "eval" in jx:
            _assert_metrics(port[r]["eval"], jx["eval"], f"eval rank {r}")
    assert port[0]["digests"] == port[1]["digests"]
    _assert_params(port[0]["params"], _flax_names(jx["params"]), port[0]["grads"], EPS,
                   f"penalty {penalty}")


class _GlobalCount:
    """The oracle's stand-in for the mesh's sum: the present objects of
    both shards, counted before."""

    def __init__(self, total, size):
        self.total, self.size = total, size

    def all_sum(self, x):
        return self.total.clone()


def _oracle(runs, penalty):
    """(eval metrics, train metrics, parameters, mean gradients) of the two
    shards run one after the other in this process."""
    obs, nums = torch.from_numpy(runs["obs"]), torch.from_numpy(runs["nums"])
    shards = [(obs[:, s * B // 2:(s + 1) * B // 2], nums[:, s * B // 2:(s + 1) * B // 2])
              for s in (0, 1)]
    model = tiny_model(aspect_penalty=penalty)
    model.sequence.load_state_dict(runs["weights"])
    noise = [{s: ReplayNoise(t, "cpu") for s, t in n.items()} for n in runs["noise2"]]

    def mean_metrics(ms):
        return Model.finalize_metrics({k: (ms[0][k] + ms[1][k]) / 2 for k in ms[0]})

    def count(stage, mode):
        with torch.no_grad():
            n = [model.loss_and_metrics(o, noise[stage][s], g, record_mode=mode)[1]
                 ["metrics"]["aspect_n"] for s, (o, g) in enumerate(shards)]
        return _GlobalCount(n[0] + n[1], 2)

    with torch.inference_mode():
        group = count(0, "full")
        ev = mean_metrics([model.loss_and_metrics(o, noise[0][s], g, group=group)[1]["metrics"]
                           for s, (o, g) in enumerate(shards)])
    group = count(1, "train")
    params = list(model.sequence.parameters())
    grads, ms = [], []
    for s, (o, g) in enumerate(shards):
        model.sequence.zero_grad(set_to_none=True)
        target, aux = model.loss_and_metrics(o, noise[1][s], g, record_mode="train", group=group)
        target.backward()
        grads.append([p.grad for p in params])
        ms.append({k: v.detach() for k, v in aux["metrics"].items()})
    opt = make_optimizer("rmsprop", LR)(params)
    for p, g0, g1 in zip(params, *grads):
        p.grad = None if g0 is None else (g0 + g1) / 2
    opt.step()
    mean_grads = {n: p.grad for n, p in model.sequence.named_parameters() if p.grad is not None}
    return ev, mean_metrics(ms), model.sequence.state_dict(), mean_grads


@pytest.mark.parametrize("penalty", PENALTIES)
def test_two_processes_equal_the_two_shard_oracle(runs, penalty):
    ev, train, params, grads = _oracle(runs, penalty)
    for r, port in enumerate(runs["port"][penalty]):
        for what, got, want in (("eval", port["eval"], ev), ("train", port["train"][0], train)):
            assert sorted(got) == sorted(want)
            for key in want:
                assert torch.equal(got[key], want[key]), f"rank {r} {what} {key}"
        for name, want in params.items():
            assert torch.equal(port["params"][name], want), f"rank {r} {name}"
        for name, want in grads.items():
            assert torch.equal(port["grads"][name], want), f"rank {r} gradient {name}"


def test_multislice_matches_a_flat_mesh_and_jax(runs):
    ms, flat = runs["port"]["multislice"], runs["port"]["flat4"]
    assert len({o["digests"][0] for o in ms}) == 1
    assert len({o["digests"][0] for o in flat}) == 1
    _assert_params(ms[0]["params"], {k: v.numpy() for k, v in flat[0]["params"].items()},
                   ms[0]["grads"], REORDER_EPS, "multislice vs flat")
    _assert_metrics(ms[0]["train"][0], {k: v.numpy() for k, v in flat[0]["train"][0].items()},
                    "multislice vs flat")
    jx = runs["jax"]["multislice"]
    _assert_metrics(ms[0]["train"][0], jx["train"], "multislice vs JAX")
    _assert_params(ms[0]["params"], _flax_names(jx["params"]), ms[0]["grads"], EPS,
                   "multislice vs JAX")


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone."""
    from sqair_tpu_torch.parallel import distributed

    assert distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()
    assert not distributed.is_initialized()


def test_one_process_equals_the_single_process_step(world_of_one):
    from sqair_tpu_torch.nn.layers import init_params

    rs = np.random.default_rng(2)
    obs = rs.uniform(size=(T, B, HW, HW)).astype(np.float32)
    nums = np.concatenate([np.ones((T, B, 1)), np.zeros((T, B, S))], -1).astype(np.float32)
    models = []
    for _ in range(2):
        m = tiny_model(aspect_penalty=0.7)
        init_params(m.sequence, torch.Generator().manual_seed(3))
        models.append(m)
    mesh = make_mesh()
    assert (mesh.rank, mesh.size) == (0, 1)
    steps = [(make_parallel_eval_step(models[0], mesh),
              make_parallel_train_step(models[0], make_optimizer("rmsprop", LR), mesh)),
             (make_eval_step(models[1]), make_train_step(models[1], make_optimizer("rmsprop", LR)))]
    out = []
    for ev, tr in steps:
        gen = torch.Generator().manual_seed(4)
        from sqair_tpu_torch.ops.noise import GeneratorNoise

        noise = GeneratorNoise(gen, "cpu")
        out.append([ev(obs, nums, noise)] + [tr(obs, nums, noise) for _ in range(2)])
    for a, b in zip(*out):
        assert sorted(a) == sorted(b)
        for key in a:
            assert torch.equal(a[key], b[key]), key
    for (name, a), b in zip(models[0].sequence.state_dict().items(),
                            models[1].sequence.state_dict().values()):
        assert torch.equal(a, b), name


def test_indivisible_batches_and_worlds_raise(world_of_one):
    model = tiny_model()
    mesh = Mesh([None], rank=0, size=3)  # shards only: no collective is reached
    step = make_parallel_train_step(model, make_optimizer("sgd", LR), mesh)
    obs = np.zeros((T, B, HW, HW), np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        step(obs, np.zeros((T, B, S + 1), np.float32), None)
    with pytest.raises(ValueError, match="not divisible"):
        make_parallel_eval_step(model, mesh)(obs, np.zeros((T, B, S + 1), np.float32), None)
    with pytest.raises(ValueError, match="not divisible into 2 slices"):
        make_multislice_mesh(2)
