"""The slice with the fused discovery unroll switched on (``SQAIR_FUSE_CELLS=1``
at a configuration with no early-discovery logit lever, so that discovery
and propagation both run fused, as in the JAX package's defaults that
``bench.py`` takes): sqair_tpu_torch's eval step, and its train-record
target and gradients, held to sqair_tpu's with the switch on both sides, at
the golden config (B=4, T=3, S=2, 24x24 frames, 8x8 glimpses), the JAX
weights converted and the JAX model's noise replayed (its fused paths draw
the discovery and propagation noise slot-major).  JAX runs its Pallas
kernels, both frame kernels included, in interpret mode; the port runs its
plain versions through the frame kernels' autograd Functions.  The train
test switches the fused glimpse encoder on too (the JAX package's
all-opt-in configuration).  Each is also held to the port's own switch-off
step under the same port noise.  The switches are set only inside each
test.

Tolerances, as tests/test_torch_cells_step.py: metrics 1e-4 on
|a - b| / (|b| + 1); gradients 1e-4 of each leaf's largest |gradient| in
the reference (+1e-7), or twice the reference's own distance from the
float64 value of the same step where that is larger.  The float64 value
comes from the port's switch-off step under the same noise, which runs none
of the code under test (the fused frame kernels), so a fault of the
switch-on path cannot widen its own bound.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.ops import fused_cells as jcells
from sqair_tpu.training import make_eval_step as jax_make_eval_step
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops import fused_cells
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.training import make_eval_step
from torch_parity import (B, NWHAT, S, T, assert_close, build_pair, f64_step_grads,
                          golden_batch, jax_noise_table, port_noise_table, spy,
                          step_grad_close, step_grads, to_numpy, tpu_kernels_interpreted)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

METRIC_TOL = 1e-4
K = 5
# no early-discovery logit lever (early_disc_logit_scale at its default, 1)
MODEL_KW = dict(transient_penalty=400.0)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model with them, obs, nums), built
    once for the module; the tests do not change the parameters."""
    jts, jdec, seq = build_pair()
    jmodel = JModel(JSequentialAIR(jts, jdec), k_particles=K, **MODEL_KW)
    obs, nums = golden_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=K, **MODEL_KW)
    assert model.sequence.timestep.discover.fused_disc_eligible()
    return jmodel, params, model, obs, nums


@functools.lru_cache(maxsize=None)
def _jax_table(seed):
    """JAX's slot-major noise for PRNGKey(seed), drawn once for the module."""
    return jax_noise_table(jax.random.PRNGKey(seed), T, S, B * K, NWHAT, fused_prop=True,
                           fused_disc=True)


def test_eval_step_with_fused_discovery_matches_jax(pair):
    jmodel, params, model, obs, nums = pair
    rng = jax.random.PRNGKey(2)
    table = port_noise_table(model, obs, nums)
    off = make_eval_step(model)(obs, nums, ReplayNoise(table, "cpu"))
    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        mp.setenv("SQAIR_FUSE_CELLS", "1")
        jcalls = spy(mp, jcells, "fused_disc_ssm")
        calls = spy(mp, fused_cells, "fused_disc_ssm")
        want = jax_make_eval_step(jmodel)(params, rng, jnp.asarray(obs), jnp.asarray(nums))
        got = make_eval_step(model)(obs, nums, ReplayNoise(_jax_table(2), "cpu"))
        on = make_eval_step(model)(obs, nums, ReplayNoise(table, "cpu"))
    # one fused call per frame in each of the two switch-on runs
    assert len(calls) == 2 * T and len(jcalls) > 0
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert_close(got[key].numpy(), np.asarray(want[key]), METRIC_TOL, key)
        assert_close(on[key].numpy(), off[key].numpy(), METRIC_TOL, f"switch on vs off: {key}")


def test_train_gradients_with_fused_discovery_match_jax(pair):
    jmodel, params, model, obs, nums = pair
    rng = jax.random.PRNGKey(2)
    table = port_noise_table(model, obs, nums)
    off, _ = step_grads(model, obs, nums, ReplayNoise(table, "cpu"))
    off64 = f64_step_grads(model, obs, nums, table)

    # JAX's noise; the float64 value of JAX's step is the port's switch-off
    # step in float64 under it (the unfused path reads the same per-slot keys)
    jtable = _jax_table(2)
    jax64 = f64_step_grads(model, obs, nums, jtable)

    def loss(p):
        target, aux = jmodel.loss_and_metrics(p, rng, jnp.asarray(obs), jnp.asarray(nums),
                                              0.0, record_mode="train")
        return target, JModel.finalize_metrics(aux["metrics"])

    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        mp.setenv("SQAIR_FUSE_CELLS", "1")
        mp.setenv("SQAIR_FUSE_GLIMPSE", "1")
        jcalls = spy(mp, jcells, "fused_disc_ssm")
        calls = spy(mp, fused_cells, "fused_disc_ssm")
        (_, want_metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        got, aux = step_grads(model, obs, nums, ReplayNoise(jtable, "cpu"))
        n_calls = len(calls)
        on, _ = step_grads(model, obs, nums, ReplayNoise(table, "cpu"))
    assert n_calls == T and len(jcalls) > 0
    metrics = Model.finalize_metrics(aux["metrics"])
    for key, want in to_numpy(want_metrics).items():
        assert_close(metrics[key].detach().numpy(), want, METRIC_TOL, key)
    want_grads = params_from_flax(to_numpy(grads))
    assert sorted(got) == sorted(want_grads)
    for name, want in want_grads.items():
        step_grad_close(got[name], want.numpy(), jax64[name], name)
        step_grad_close(on[name], off[name].numpy(), off64[name], f"{name} switch on vs off")
