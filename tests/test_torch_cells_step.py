"""The slice with the fused propagation unroll switched on
(``SQAIR_FUSE_CELLS=1``): sqair_tpu_torch's eval step, and its train-record
target and gradients, held to sqair_tpu's with the switch on both sides, at
the golden config (B=4, T=3, S=2, 24x24 frames, 8x8 glimpses) with the
release model's levers (early_disc_logit_scale 0.15, so that discovery runs
unfused on both sides), the JAX weights converted and the JAX model's noise
replayed (its fused path draws the propagation noise slot-major).  JAX runs
its Pallas kernels, the propagation kernel included, in interpret mode; the
port runs its plain versions through the propagation's autograd Function.
The train test switches the fused glimpse encoder on too (the JAX package's
all-opt-in configuration).  Each is also held to the port's own switch-off
step under the same port noise.  The switches are set only inside each test.

Tolerances, as tests/test_torch_glimpse_step.py: metrics 1e-4 on
|a - b| / (|b| + 1); gradients 1e-4 of each leaf's largest |gradient| in
the reference (+1e-7), or twice the reference's own distance from the
float64 value of the same step where that is larger.  The float64 value
comes from the port's switch-off step under the same noise, which runs none
of the code under test (the fused propagation), so a fault of the switch-on
path cannot widen its own bound.  The second form holds a scalar whose
gradient is a sum with heavy cancellation
(``propagate...transform_estimator.scale_offset``: 8.2e-4 from terms of
~1e-2 here), for which a bound relative to its own size asks for more than
f32 gives either side.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.ops import fused_cells as jcells
from sqair_tpu.training import make_eval_step as jax_make_eval_step
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops import fused_cells
from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
from sqair_tpu_torch.training import make_eval_step
from torch_parity import (B, NWHAT, S, T, assert_close, build_pair, golden_batch,
                          jax_noise_table, to_numpy, tpu_kernels_interpreted)

METRIC_TOL = 1e-4
GRAD_TOL = 1e-4
K = 5
LEVERS = dict(timestep=dict(early_disc_logit_scale=0.15), model=dict(transient_penalty=400.0))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model with them, obs, nums), built
    once for the module (the JAX init compiles for ~8 s); the tests do not
    change the parameters."""
    jts, jdec, seq = build_pair(**LEVERS["timestep"])
    jmodel = JModel(JSequentialAIR(jts, jdec), k_particles=K, **LEVERS["model"])
    obs, nums = golden_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=K, **LEVERS["model"])
    return jmodel, params, model, obs, nums


def _spy(mp, module, name):
    """Counts the calls of module.name (for JAX: while tracing)."""
    calls = []
    real = getattr(module, name)
    mp.setattr(module, name, lambda *a: calls.append(1) or real(*a))
    return calls


def _port_table(model, obs, nums):
    """The port's own noise for one step, drawn switch off."""
    noise = GeneratorNoise(torch.Generator().manual_seed(3), "cpu", record=True)
    make_eval_step(model)(obs, nums, noise)
    # out of the eval step's inference mode, for autograd
    return {key: v.clone() for key, v in noise.table.items()}


def _grads(model, obs, nums, noise):
    model.sequence.zero_grad(set_to_none=True)
    target, aux = model.loss_and_metrics(torch.from_numpy(obs), noise, torch.from_numpy(nums),
                                         record_mode="train")
    target.backward()
    out = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
           for n, p in model.sequence.named_parameters()}
    model.sequence.zero_grad(set_to_none=True)
    return out, aux


def _f64_grads(model, obs, nums, table):
    """The same step's gradients with the model and the noise in float64."""
    m64 = copy.copy(model)
    m64.sequence = copy.deepcopy(model.sequence).double()
    return _grads(m64, obs.astype(np.float64), nums.astype(np.float64),
                  ReplayNoise(table, "cpu", dtype=torch.float64))[0]


def _grad_close(got, want, g64, name):
    """|got - want| <= max(GRAD_TOL max|want| + 1e-7, 2 max|want - g64|)."""
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    f32_noise = float(np.max(np.abs(want - g64.numpy()))) if want.size else 0.0
    tol = max(GRAD_TOL * float(np.max(np.abs(want))) + 1e-7, 2.0 * f32_noise)
    assert err <= tol, f"d{name}: {err:.3g} > {tol:.3g}"


def test_eval_step_with_the_cells_switch_matches_jax(pair):
    jmodel, params, model, obs, nums = pair
    rng = jax.random.PRNGKey(2)
    table = _port_table(model, obs, nums)
    off = make_eval_step(model)(obs, nums, ReplayNoise(table, "cpu"))
    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        mp.setenv("SQAIR_FUSE_CELLS", "1")
        jcalls = _spy(mp, jcells, "fused_prop_ssm")
        calls = _spy(mp, fused_cells, "fused_prop_ssm")
        want = jax_make_eval_step(jmodel)(params, rng, jnp.asarray(obs), jnp.asarray(nums))
        noise = ReplayNoise(jax_noise_table(rng, T, S, B * K, NWHAT, fused_prop=True), "cpu")
        got = make_eval_step(model)(obs, nums, noise)
        on = make_eval_step(model)(obs, nums, ReplayNoise(table, "cpu"))
    # one fused call per frame in each of the two switch-on runs
    assert len(calls) == 2 * T and len(jcalls) > 0
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert_close(got[key].numpy(), np.asarray(want[key]), METRIC_TOL, key)
        assert_close(on[key].numpy(), off[key].numpy(), METRIC_TOL, f"switch on vs off: {key}")


def test_train_gradients_with_the_cells_switch_match_jax(pair):
    jmodel, params, model, obs, nums = pair
    rng = jax.random.PRNGKey(2)
    table = _port_table(model, obs, nums)
    off, _ = _grads(model, obs, nums, ReplayNoise(table, "cpu"))
    off64 = _f64_grads(model, obs, nums, table)

    # JAX's noise; the float64 value of JAX's step is the port's switch-off
    # step in float64 under it (the unfused path reads the same per-slot keys)
    jtable = jax_noise_table(rng, T, S, B * K, NWHAT, fused_prop=True)
    jax64 = _f64_grads(model, obs, nums, jtable)

    def loss(p):
        target, aux = jmodel.loss_and_metrics(p, rng, jnp.asarray(obs), jnp.asarray(nums),
                                              0.0, record_mode="train")
        return target, JModel.finalize_metrics(aux["metrics"])

    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        mp.setenv("SQAIR_FUSE_CELLS", "1")
        mp.setenv("SQAIR_FUSE_GLIMPSE", "1")
        jcalls = _spy(mp, jcells, "fused_prop_ssm")
        calls = _spy(mp, fused_cells, "fused_prop_ssm")
        (_, want_metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        got, aux = _grads(model, obs, nums, ReplayNoise(jtable, "cpu"))
        n_calls = len(calls)
        on, _ = _grads(model, obs, nums, ReplayNoise(table, "cpu"))
    assert n_calls == T and len(jcalls) > 0
    metrics = Model.finalize_metrics(aux["metrics"])
    for key, want in to_numpy(want_metrics).items():
        assert_close(metrics[key].detach().numpy(), want, METRIC_TOL, key)
    want_grads = params_from_flax(to_numpy(grads))
    assert sorted(got) == sorted(want_grads)
    for name, want in want_grads.items():
        _grad_close(got[name], want.numpy(), jax64[name], name)
        _grad_close(on[name], off[name].numpy(), off64[name], f"{name} switch on vs off")
