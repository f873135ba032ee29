"""The slice with the fused glimpse encoder switched on: sqair_tpu_torch's
eval step, and its train-record target and gradients, held to sqair_tpu's
with ``SQAIR_FUSE_GLIMPSE=1`` on both sides, at the golden config (B=4, T=3,
S=2, 24x24 frames, 8x8 glimpses) with the release model's levers, the JAX
weights converted and the JAX model's noise replayed (the glimpse draws no
noise of its own).  JAX runs its Pallas kernels, the glimpse kernel
included, in interpret mode; the port runs its plain versions through the
glimpse's autograd Function.  The switch is set only inside each test.

Tolerances, as tests/test_torch_eval_step.py and
tests/test_torch_train_grads.py: metrics 1e-4 on |a - b| / (|b| + 1);
gradients 1e-4 of each leaf's largest |gradient| in JAX (+1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.ops import fused_glimpse as jglimpse
from sqair_tpu.training import make_eval_step as jax_make_eval_step
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops import fused_glimpse
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.training import make_eval_step
from torch_parity import (B, NWHAT, S, T, assert_close, build_pair, golden_batch,
                          jax_noise_table, to_numpy, tpu_kernels_interpreted)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

METRIC_TOL = 1e-4
GRAD_TOL = 1e-4
K = 5
LEVERS = dict(timestep=dict(early_disc_logit_scale=0.15), model=dict(transient_penalty=400.0))


def _pair():
    jts, jdec, seq = build_pair(**LEVERS["timestep"])
    jmodel = JModel(JSequentialAIR(jts, jdec), k_particles=K, **LEVERS["model"])
    obs, nums = golden_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=K, **LEVERS["model"])
    return jmodel, params, model, obs, nums


def _spy_on_jax_glimpse(mp):
    """Counts the JAX package's fused glimpse calls (while tracing)."""
    calls = []
    real = jglimpse.fused_glimpse_encoder
    mp.setattr(jglimpse, "fused_glimpse_encoder", lambda *a: calls.append(1) or real(*a))
    return calls


def _spy_on_port_glimpse(mp):
    calls = []
    real = fused_glimpse.fused_glimpse_encoder
    mp.setattr(fused_glimpse, "fused_glimpse_encoder", lambda *a: calls.append(1) or real(*a))
    return calls


def test_eval_step_with_the_glimpse_switch_matches_jax():
    jmodel, params, model, obs, nums = _pair()
    rng = jax.random.PRNGKey(2)
    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        mp.setenv("SQAIR_FUSE_GLIMPSE", "1")
        jcalls, calls = _spy_on_jax_glimpse(mp), _spy_on_port_glimpse(mp)
        want = jax_make_eval_step(jmodel)(params, rng, jnp.asarray(obs), jnp.asarray(nums))
        noise = ReplayNoise(jax_noise_table(rng, T, S, B * K, NWHAT), "cpu")
        got = make_eval_step(model)(obs, nums, noise)
    # one call per discovery slot, two per propagation slot, in every frame
    assert len(calls) == 3 * S * T and len(jcalls) > 0
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert_close(got[key].numpy(), np.asarray(want[key]), METRIC_TOL, key)


def test_train_gradients_with_the_glimpse_switch_match_jax():
    jmodel, params, model, obs, nums = _pair()
    rng = jax.random.PRNGKey(2)

    def loss(p):
        target, aux = jmodel.loss_and_metrics(p, rng, jnp.asarray(obs), jnp.asarray(nums),
                                              0.0, record_mode="train")
        return target, JModel.finalize_metrics(aux["metrics"])

    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        mp.setenv("SQAIR_FUSE_GLIMPSE", "1")
        jcalls, calls = _spy_on_jax_glimpse(mp), _spy_on_port_glimpse(mp)
        (_, want_metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        model.sequence.zero_grad(set_to_none=True)
        target, aux = model.loss_and_metrics(
            torch.from_numpy(obs), ReplayNoise(jax_noise_table(rng, T, S, B * K, NWHAT), "cpu"),
            torch.from_numpy(nums), record_mode="train")
        target.backward()
    assert len(calls) == 3 * S * T and len(jcalls) > 0
    metrics = Model.finalize_metrics(aux["metrics"])
    for key, want in to_numpy(want_metrics).items():
        assert_close(metrics[key].detach().numpy(), want, METRIC_TOL, key)
    want_grads = params_from_flax(to_numpy(grads))
    got = dict(model.sequence.named_parameters())
    assert sorted(got) == sorted(want_grads)
    for name, want in want_grads.items():
        p = got[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        want = want.numpy().astype(np.float64)
        err = float(np.max(np.abs(g.numpy() - want))) if want.size else 0.0
        tol = GRAD_TOL * float(np.max(np.abs(want))) + 1e-7
        assert err <= tol, f"d{name}: {err:.3g} > {tol:.3g}"
