"""The model options that a researcher sets by flag or module argument,
held to the JAX package in a train step at the golden config (B=4, T=3,
S=2, 24x24 frames, k=2), the JAX weights converted and its noise replayed:
the propagation prior's "rw" mode with the LSTM in all three cell roles
(the transition, the temporal cell and the prior cell), its "guided" mode
with learnable and bounded decoder stds, and the discovery coverage
signal (three cases: each costs JAX a compile of its step).  Each case
compares the train record's target and metrics (1e-4 on |a - b| / (|b| +
1)) and every parameter's gradient at the allowance of
tests/test_torch_pedestrian_step.py: 1e-4 of the leaf's largest |gradient|
in JAX (+1e-7), or twice JAX's own distance from the float64 value of its
step where that is larger (the port's step in float64 under JAX's noise,
none of the code under test).  JAX runs its TPU kernels in interpret
mode.

Beside them: ``coverage_paste`` against JAX's (the canvas read back, and
its gradient), the padding tool (tools/pad_coverage_params_torch.py) keeping
a flag-off model's function with the signal on, and the switches leaving
the coverage model's discovery unfused.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import AIRDecoder as JAIRDecoder
from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.models import SQAIRTimestep as JTimestep
from sqair_tpu.models import core as jcore
from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.models import AIRDecoder, Model, SequentialAIR, SQAIRTimestep
from sqair_tpu_torch.models import core
from sqair_tpu_torch.nn.layers import init_params
from sqair_tpu_torch.ops import fused_cells
from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
from sqair_tpu_torch.training import make_eval_step
from torch_parity import (B, G, H, NH, NWHAT, S, T, _kwargs, assert_close, f64_step_grads,
                          golden_batch, jax_noise_table, spy, step_grad_close, step_grads,
                          to_numpy, tpu_kernels_interpreted)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import pad_coverage_params_torch  # noqa: E402

METRIC_TOL = 1e-4
K = 2
LEARNED_STDS = dict(learn_std=True, learn_bg_std=True, bg_std=0.4, min_std=0.1,
                    bg_bigger_than_fg_std=True)
CASES = {
    "rw_prior_lstm_cells": dict(timestep=dict(prop_prior_type="rw", transition="LSTM",
                                              time_transition="LSTM",
                                              prior_transition="LSTM")),
    "guided_prior_learned_stds": dict(timestep=dict(prop_prior_type="guided"),
                                      decoder=LEARNED_STDS),
    "coverage_signal": dict(timestep=dict(disc_coverage_signal=True)),
}


def build(timestep=(), decoder=()):
    """(JAX Model, the port's SequentialAIR) at the golden widths."""
    timestep, decoder = dict(timestep), dict(decoder)
    mean = np.zeros((H, H), np.float32)
    jdec = JAIRDecoder(img_size=(H, H), glimpse_size=(G, G), glimpse_n_hiddens=[NH],
                       mean_img=mean, output_std=0.3, **decoder)
    dec = AIRDecoder(img_size=(H, H), glimpse_size=(G, G), n_what=NWHAT,
                     glimpse_n_hiddens=[NH], mean_img=mean, output_std=0.3, **decoder)
    jmodel = JModel(JSequentialAIR(JTimestep(**_kwargs(**timestep)), jdec), k_particles=K)
    return jmodel, SequentialAIR(SQAIRTimestep(**_kwargs(**timestep)), dec)


@pytest.mark.parametrize("name", sorted(CASES))
def test_option_train_step_matches_jax(name):
    jmodel, seq = build(**CASES[name])
    obs, nums = golden_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    rng = jax.random.PRNGKey(2)

    def loss(p):
        target, aux = jmodel.loss_and_metrics(p, rng, jnp.asarray(obs), jnp.asarray(nums), 0.0,
                                              record_mode="train")
        return target, JModel.finalize_metrics(aux["metrics"])

    with tpu_kernels_interpreted():
        (want_target, want_metrics), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=K)
    table = jax_noise_table(rng, T, S, B * K, NWHAT)
    got, aux = step_grads(model, obs, nums, ReplayNoise(table, "cpu"))
    metrics = Model.finalize_metrics(aux["metrics"])
    for key, want in to_numpy(want_metrics).items():
        assert_close(metrics[key].detach().numpy(), want, METRIC_TOL, f"{name} {key}")
    want_grads = params_from_flax(to_numpy(grads))
    assert sorted(got) == sorted(want_grads)
    jax64 = f64_step_grads(model, obs, nums, table)
    for pname, want in want_grads.items():
        step_grad_close(got[pname], want.numpy(), jax64[pname], f"{name} {pname}")
    if "stds" in name:
        # learnable: the stds move with the loss
        for std in ("decoder.output_std", "decoder.background_std"):
            assert float(np.abs(want_grads[std].numpy())) > 0, std
    if "lstm" in name:
        # the three roles' LSTMs, each with its gradient
        lstm = [n for n in got if n.endswith("ifgo.kernel")]
        assert len(lstm) == 4 and all(np.any(want_grads[n].numpy()) for n in lstm), lstm


def test_stds_get_no_gradient_unless_learnable():
    _, seq = build()
    init_params(seq, torch.Generator().manual_seed(0))
    fg, bg = seq.decoder.stds()
    assert not fg.requires_grad and not bg.requires_grad
    assert float(fg) == pytest.approx(0.3) and float(bg) == pytest.approx(0.3)
    _, seq = build(decoder=LEARNED_STDS)
    init_params(seq, torch.Generator().manual_seed(0))
    fg, bg = seq.decoder.stds()
    assert fg.requires_grad and bg.requires_grad
    # the JAX package's min_std reparametrisation: raw^2 = value - min_std,
    # offset 2 value min_std - min_std^2
    for got, value in ((fg, 0.3), (bg, 0.4)):
        assert float(got.detach()) == pytest.approx(value - 0.1 + 2 * value * 0.1 - 0.01,
                                                    abs=1e-6)
    with pytest.raises(ValueError, match="min_std"):
        build(decoder=dict(min_std=0.5))


@pytest.mark.parametrize("slotted", [False, True])
def test_coverage_paste_matches_jax(slotted):
    """The canvas read back after a paste, and the gradient of a weighted sum
    of it with respect to the coords."""
    rs = np.random.default_rng(3)
    lead = (B, S) if slotted else (B,)
    coverage = (rs.uniform(size=(B, H, H)) * 0.5).astype(np.float32)
    coverage[0] = 0.0
    coords = np.concatenate([rs.uniform(0.2, 0.6, lead + (2,)),
                             rs.uniform(-0.5, 0.5, lead + (2,))], -1).astype(np.float32)
    presence = (rs.uniform(size=lead + (1,)) > 0.3).astype(np.float32)
    w = rs.standard_normal((B, H, H)).astype(np.float32)

    def jfn(c):
        return jcore.coverage_paste(jnp.asarray(coverage), c, jnp.asarray(presence), (G, G))

    want = np.asarray(jfn(jnp.asarray(coords)))
    jgrad = np.asarray(jax.grad(lambda c: jnp.sum(jfn(c) * w))(jnp.asarray(coords)))
    ct = torch.tensor(coords, requires_grad=True)
    got = core.coverage_paste(torch.from_numpy(coverage), ct, torch.from_numpy(presence), (G, G))
    assert_close(got.detach().numpy(), want, 1e-5, "canvas")
    assert float(got.detach().min()) >= 0.0 and float(got.detach().max()) <= 1.0
    torch.sum(got * torch.from_numpy(w)).backward()
    assert_close(ct.grad.numpy(), jgrad, 1e-5, "d coords")


def test_padding_tool_preserves_the_function():
    """A flag-off model's weights, padded with 16 zero rows, give the same
    metrics with the coverage signal on; an optimizer state pads alike."""
    flags = dict(mlp_mnist_model.DEFAULTS, n_units=1, n_what=NWHAT, n_steps_per_image=S,
                 glimpse_size=G, k_particles=K)
    off = mlp_mnist_model.load(flags, (H, H), device="cpu", seed=3)
    on = mlp_mnist_model.load(dict(flags, disc_coverage_signal=True), (H, H), device="cpu",
                              seed=4)
    padded, hits = pad_coverage_params_torch.pad_for_coverage(off.sequence.state_dict())
    assert hits == ["timestep.discover.cell.steps_predictor.MLP_0.w_0"]
    on.sequence.load_state_dict(padded, strict=True)
    obs, nums = golden_batch()
    noise = GeneratorNoise(torch.Generator().manual_seed(1), "cpu", record=True)
    want = make_eval_step(off)(obs, nums, noise)
    got = make_eval_step(on)(obs, nums, ReplayNoise(noise.table, "cpu"))
    for key in want:
        assert_close(got[key].numpy(), want[key].numpy(), 1e-6, key)
    state = {"count": 3, "nu": {hits[0]: torch.ones(41, 16)}, "trace": {hits[0]: torch.ones(41, 16)}}
    out = pad_coverage_params_torch.pad_optimizer_state(state)
    assert out["nu"][hits[0]].shape == (57, 16) and not out["trace"][hits[0]][41:].any()
    with pytest.raises(ValueError, match="exactly one"):
        pad_coverage_params_torch.pad_for_coverage({"a.w_0": torch.zeros(2, 2)})


def test_coverage_keeps_discovery_unfused_under_both_switches(monkeypatch):
    """JAX's gate: the fused discovery kernel has no coverage input.  At
    DISC_FLAGS-like levers (no early-discovery lever) the MLP model's
    discovery fuses, and with the coverage signal it does not."""
    monkeypatch.setenv("SQAIR_FUSE_CELLS", "1")
    monkeypatch.setenv("SQAIR_FUSE_GLIMPSE", "1")
    flags = dict(mlp_mnist_model.DEFAULTS, n_units=1, n_what=NWHAT, n_steps_per_image=S,
                 glimpse_size=G, k_particles=K)
    obs, nums = golden_batch()
    for coverage in (False, True):
        model = mlp_mnist_model.load(dict(flags, disc_coverage_signal=coverage), (H, H),
                                     device="cpu")
        calls = spy(monkeypatch, fused_cells, "fused_disc_ssm")
        make_eval_step(model)(obs, nums, GeneratorNoise(torch.Generator().manual_seed(1), "cpu"))
        assert model.sequence.timestep.discover.fused_disc_eligible() == (not coverage)
        assert len(calls) == (0 if coverage else T)
