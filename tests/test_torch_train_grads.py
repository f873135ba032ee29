"""The training slice's loss and gradients: sqair_tpu_torch's
``Model.loss_and_metrics(record_mode="train")`` and ``loss.backward()`` held
to ``jax.value_and_grad`` of sqair_tpu's, at the golden config (B=4, T=3,
S=2, 24x24 frames) with the JAX weights converted and the JAX model's noise
replayed.  Every parameter is matched by its flax path.  JAX runs its TPU
kernels (interpreted), whose backward the port's follows
(torch_parity.tpu_kernels_interpreted).

Tolerances:
- metrics and target: 1e-4 on |a - b| / (|b| + 1), as the eval-step test
  (f32 on both sides, summed over T x 2S dependent cell steps);
- gradients: 1e-4 of each leaf's largest |gradient| in JAX (plus 1e-7 for
  leaves whose gradient is 0): the backward runs the same chains in reverse,
  and a leaf's small entries carry the rounding of its large ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops.noise import ReplayNoise
from torch_parity import (B, NWHAT, S, T, assert_close, build_pair, golden_batch,
                          jax_noise_table, to_numpy, tpu_kernels_interpreted)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

METRIC_TOL = 1e-4
GRAD_TOL = 1e-4

CONFIGS = {
    # the transient-discovery penalty in the gradient
    "k2_transient": dict(k=2, timestep={}, model=dict(transient_penalty=2.0), l2=0.0),
    # the release model's levers (release_models/mnist_mlp/1/flags.json)
    "k5_release_levers": dict(k=5, timestep=dict(early_disc_logit_scale=0.15),
                              model=dict(transient_penalty=400.0), l2=0.0),
    # branches no other case reaches: the geometric count prior, the
    # non-recurrent where prior, the unmasked glimpse, the aspect penalty and
    # one particle (REINFORCE)
    "k1_untested_branches": dict(k=1, timestep=dict(disc_prior_type="geom",
                                                    rec_where_prior=False,
                                                    masked_glimpse=False),
                                 model=dict(aspect_penalty=0.7), l2=0.0),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    """JAX's train-record target, metrics and gradients, computed once."""
    cfg = CONFIGS[request.param]
    jts, jdec, seq = build_pair(**cfg["timestep"])
    jmodel = JModel(JSequentialAIR(jts, jdec), k_particles=cfg["k"], **cfg["model"])
    obs, nums = golden_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    rng = jax.random.PRNGKey(2)

    def loss(p):
        target, aux = jmodel.loss_and_metrics(p, rng, jnp.asarray(obs), jnp.asarray(nums),
                                              cfg["l2"], record_mode="train")
        return target, JModel.finalize_metrics(aux["metrics"])

    with tpu_kernels_interpreted():
        (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=cfg["k"],
                  **cfg["model"])
    table = jax_noise_table(rng, T, S, B * cfg["k"], NWHAT)
    return dict(name=request.param, cfg=cfg, model=model, obs=obs, nums=nums,
                table=table, metrics=to_numpy(metrics), grads=params_from_flax(to_numpy(grads)))


def test_train_loss_and_grads_match_jax(case):
    model, cfg = case["model"], case["cfg"]
    model.sequence.zero_grad(set_to_none=True)
    target, aux = model.loss_and_metrics(
        torch.from_numpy(case["obs"]), ReplayNoise(case["table"], "cpu"),
        torch.from_numpy(case["nums"]), l2_weight=cfg["l2"], record_mode="train")
    target.backward()
    metrics = Model.finalize_metrics(aux["metrics"])
    assert sorted(metrics) == sorted(case["metrics"])
    for key, want in case["metrics"].items():
        assert_close(metrics[key].detach().numpy(), want, METRIC_TOL, f"{case['name']} {key}")

    got = dict(model.sequence.named_parameters())
    assert sorted(got) == sorted(case["grads"])
    for name, want in case["grads"].items():
        p = got[name]
        g = torch.zeros_like(p) if p.grad is None else p.grad
        want = want.numpy().astype(np.float64)
        err = float(np.max(np.abs(g.numpy() - want))) if want.size else 0.0
        tol = GRAD_TOL * float(np.max(np.abs(want))) + 1e-7
        assert err <= tol, f"{case['name']} d{name}: {err:.3g} > {tol:.3g}"


def test_train_record_matches_full_record(case):
    """The train record gives the full record's target and metrics with the
    same noise (the full-only per-frame count metrics aside)."""
    model = case["model"]
    obs, nums = torch.from_numpy(case["obs"]), torch.from_numpy(case["nums"])
    with torch.no_grad():
        full_t, full = model.loss_and_metrics(obs, ReplayNoise(case["table"], "cpu"), nums)
        train_t, train = model.loss_and_metrics(obs, ReplayNoise(case["table"], "cpu"), nums,
                                                record_mode="train")
    full, train = full["metrics"], train["metrics"]
    assert sorted(set(full) - set(train)) == ["num_step_acc_per_t", "num_steps_per_t"]
    assert set(train) <= set(full)
    for key in train:
        assert_close(train[key].numpy(), full[key].numpy(), 1e-6, f"{case['name']} {key}")
    assert_close(train_t.numpy(), full_t.numpy(), 1e-6, "target")


def test_decoder_std_grads_are_zero(case):
    """The decoder's fg / bg std parameters get exactly zero gradient, as
    jax.grad gives (the JAX package stops their gradient), in the full
    record too."""
    model = case["model"]
    model.sequence.zero_grad(set_to_none=True)
    target, _ = model.loss_and_metrics(
        torch.from_numpy(case["obs"]), ReplayNoise(case["table"], "cpu"),
        torch.from_numpy(case["nums"]))
    target.backward()
    dec = model.sequence.decoder
    for name in ("output_std", "background_std"):
        assert float(np.max(np.abs(case["grads"]["decoder." + name].numpy()))) == 0.0
        grad = getattr(dec, name).grad
        assert grad is None or float(grad.abs().max()) == 0.0, f"{name}: {grad}"
    assert dec.mean_img.grad is not None and float(dec.mean_img.grad.abs().max()) > 0
