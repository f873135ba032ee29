"""The whole slice: sqair_tpu_torch's eval step held to sqair_tpu's
(training.make_eval_step -> Model.loss_and_metrics, full record) at the
golden config (B=4, T=3, S=2, 24x24 frames), with the JAX weights converted
and the JAX model's noise replayed.

Tolerance 1e-4 on |a - b| / (|b| + 1) for every metric: f32 on both sides,
differences summed over T x 2S dependent cell steps and the 24x24 likelihood.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.training import make_eval_step as jax_make_eval_step
from sqair_tpu_torch.convert import load_flax_params
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.training import make_eval_step
from torch_parity import B, H, NWHAT, S, T, assert_close, build_pair, jax_noise_table, to_numpy

TOL = 1e-4

CONFIGS = {
    "k2": dict(k=2, timestep={}),
    # the release model's early-frame discovery lever
    "k5_early_logit_scale": dict(k=5, timestep=dict(early_disc_logit_scale=0.15)),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eval_metrics_match_jax(name):
    cfg = CONFIGS[name]
    k = cfg["k"]
    jts, jdec, seq = build_pair(**cfg["timestep"])
    jmodel = JModel(JSequentialAIR(jts, jdec), k_particles=k)
    rs = np.random.default_rng(5)
    # frames with structure: two bright squares on a dim background
    obs = (rs.uniform(size=(T, B, H, H)) * 0.2).astype(np.float32)
    obs[:, :, 4:12, 5:13] += 0.8
    obs[:, 1::2, 14:22, 12:20] += 0.8
    nums = np.zeros((T, B, S + 1), np.float32)
    nums[:, :, 0] = 1
    nums[:, 1::2, 1] = 1
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    rng = jax.random.PRNGKey(2)
    want = jax_make_eval_step(jmodel)(params, rng, jnp.asarray(obs), jnp.asarray(nums))

    load_flax_params(seq, to_numpy(params))
    noise = ReplayNoise(jax_noise_table(rng, T, S, B * k, NWHAT), "cpu")
    got = make_eval_step(Model(seq, k_particles=k))(obs, nums, noise)

    assert sorted(got) == sorted(want)
    for key in sorted(want):
        assert_close(got[key].numpy(), np.asarray(want[key]), TOL, f"{name} {key}")
