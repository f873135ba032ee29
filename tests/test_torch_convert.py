"""The release checkpoint (release_models/mnist_mlp/1) converts into the
port and loads strictly into a model built from its flags.json, and one
frame of both packages agrees at B=2 with the JAX noise replayed.

Tolerance 5e-5 on |a - b| / (|b| + 1): f32 on both sides through one
frame of three propagation and three discovery slot steps.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import AIRDecoder as JAIRDecoder
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.models import SQAIRTimestep as JSQAIRTimestep
from sqair_tpu.training import restore_params
from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.data import create_seq_dataset, make_template_bank
from sqair_tpu_torch.ops.noise import ReplayNoise
from torch_parity import assert_close, jax_noise_table, to_numpy

RELEASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "release_models", "mnist_mlp", "1")
B = 2
FIELDS = ("what", "what_loc", "where", "where_scale", "presence", "presence_logit",
          "canvas", "log_weights_per_timestep", "num_steps_per_sample")


def _jax_model(F, img_size):
    """The JAX package's model at the release flags (configs/mlp_mnist_model.py)."""
    h = 32 * F["n_units"]
    glimpse = (F["glimpse_size"],) * 2
    ts = JSQAIRTimestep(
        n_steps=F["n_steps_per_image"], img_size=img_size, glimpse_size=glimpse,
        n_what=F["n_what"], n_hidden=h, n_layers=2, steps_pred_hidden=(h // 2,),
        transition=F["transition"], time_transition=F["time_transition"],
        prior_transition=F["prior_transition"], transform_var_bias=F["transform_var_bias"],
        disc_step_bias=F["disc_step_bias"], prop_step_bias=F["prop_step_bias"],
        prop_prior_step_bias=F["prop_prior_step_bias"], prop_prior_type=F["prop_prior_type"],
        step_success_prob=F["step_success_prob"], disc_prior_type=F["disc_prior_type"],
        rec_where_prior=F["rec_where_prior"], early_disc_step_bias=F["early_disc_step_bias"],
        early_disc_horizon=F["early_disc_horizon"],
        early_disc_logit_bias=F["early_disc_logit_bias"],
        early_disc_logit_scale=F["early_disc_logit_scale"],
        early_disc_logit_clamp=F["early_disc_logit_clamp"],
        scale_prior=(float(F["scale_prior"]),) * 2, masked_glimpse=F["masked_glimpse"])
    dec = JAIRDecoder(img_size=img_size, glimpse_size=glimpse, glimpse_n_hiddens=(h, h),
                      glimpse_output_scale=F["output_scale"],
                      mean_img=np.zeros(img_size, np.float32), output_std=F["output_std"])
    return JSequentialAIR(ts, dec)


def test_release_checkpoint_converts_and_matches_one_frame():
    with open(os.path.join(RELEASE, "flags.json")) as f:
        flags = json.load(f)
    data = create_seq_dataset(n_samples=B, n_timesteps=1, seed=7,
                              templates=make_template_bank(8, 28, seed=0), n_objects=(1, 2))
    obs = data["imgs"].astype(np.float32) / 255.0  # [1, B, 50, 50]
    img_size = obs.shape[2:]

    jseq = _jax_model(flags, img_size)
    shapes = jax.eval_shape(lambda r: jseq.init(r, jnp.asarray(obs)), jax.random.PRNGKey(0))
    example = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    ckpt = [d for d in os.listdir(RELEASE) if d.startswith("ckpt-")][0]
    params = to_numpy(restore_params(os.path.join(RELEASE, ckpt), example))

    model = mlp_mnist_model.load(flags, img_size, mean_img=np.zeros(img_size, np.float32),
                                 device="cpu")
    seq = model.sequence
    load_flax_params(seq, params)
    with pytest.raises(KeyError, match="missing"):
        params_from_flax({"timestep": params["timestep"]}, seq)

    rng = jax.random.PRNGKey(3)
    want = jseq(params, rng, jnp.asarray(obs))
    n_steps, n_what = flags["n_steps_per_image"], flags["n_what"]
    noise = ReplayNoise(jax_noise_table(rng, 1, n_steps, B, n_what), "cpu")
    with torch.inference_mode():
        got = seq(torch.from_numpy(obs), noise)
    assert float(np.sum(np.asarray(want["presence"]))) > 0, "the trained model finds objects"
    for key in FIELDS:
        assert_close(got[key].numpy(), np.asarray(want[key]), 5e-5, key)
