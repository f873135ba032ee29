"""chip_smoke.py's table of kernel calls (``main_path_shapes``), from which
it derives the launch counts the card must show, held to the calls the
port's eval and train steps really make.  The model is built as the script
builds it, by the config loader from release-model flags, at small widths
(n_units 1, n_what 8, 2 slots, 24x24 frames); its calls are counted on the
CPU: every forward wrapper call by kernel, rows and widths, and one
backward call per forward call in the train step.  With
SQAIR_FUSE_GLIMPSE the glimpse encoder and its mask leave fused_mlp for the
fused glimpse kernel, once per discovery slot and twice per propagation
slot.  With SQAIR_FUSE_CELLS each frame's propagation is one fused_prop
call, and its slots' MLPs, cells and glimpses leave the other kernels; at
these flags (early_disc_logit_scale 0.15) discovery stays unfused, as in the
JAX package, and at DISC_FLAGS (the same with early_disc_logit_scale 1) each
frame's discovery, the input encoder included, is one fused_disc call.
Each test also runs at the pedestrian configuration (``pedestrian_model``:
a non-square glimpse, here 10x4, on non-square 24x18 frames, at the
module defaults, where discovery fuses with both switches).  Under
generation (sample_from_prior with generate_after, the rollout's model) the
train record keeps its log-probs and decode in the loop and every frame
samples discovery's where prior, one more call of its cell a slot.

Under both switches, as JAX's gates decide: the conv model
(``conv_mnist_model``, here conv_channels "4,8" and 10x10 glimpses on the
24x24 frames) launches none of the glimpse and frame kernels; the LSTM in
all three cell roles (at DISC_FLAGS, where the MLP model's discovery would
fuse) none of the frame kernels, its glimpses still fused; the coverage
signal (at DISC_FLAGS) no fused discovery, its propagation and glimpses
still fused."""
import collections
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model, pedestrian_model
from sqair_tpu_torch.ops import fused, fused_cells, fused_glimpse
from sqair_tpu_torch.ops.noise import GeneratorNoise
from torch_parity import B, H, S, T, golden_batch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

FLAGS = dict(n_units=1, n_what=8, n_steps_per_image=S, glimpse_size=8, k_particles=2,
             early_disc_logit_scale=0.15, transient_disc_penalty=2.0)
DISC_FLAGS = dict(FLAGS, **chip_smoke.DISC_LEVERS)
PED_FLAGS = dict(n_units=1, n_what=8, n_steps_per_image=S, k_particles=2, glimpse_hw="10,4",
                 transient_disc_penalty=2.0)
PED_IMG = (H, 18)
OPTION_FLAGS = {
    "conv": dict(FLAGS, model_config="sqair_tpu/configs/conv_mnist_model.py",
                 conv_channels="4,8", glimpse_size=10),
    "lstm": dict(DISC_FLAGS, transition="LSTM", time_transition="LSTM",
                 prior_transition="LSTM"),
    "coverage": dict(DISC_FLAGS, disc_coverage_signal=True),
}


def _modes(*extra):
    """(mode, *extra, config) cases: the release-like flags keep their ids,
    the pedestrian configuration's are marked."""
    cases = [(mode, *extra, config) for config in ("release", "pedestrian")
             for mode in ("full", "train")]
    return [pytest.param(*c, id="-".join([c[0]] + [str(e) for e in c[1:-1]])
                         + ("" if c[-1] == "release" else "-pedestrian")) for c in cases]
FORWARD = ("fused_mlp", "fused_vanilla_rnn", "fused_gru")


def _key(kernel, shape):
    if kernel == "fused_mlp":
        return (kernel, shape["n"], shape["d_in"], tuple(shape["widths"]), tuple(shape["acts"]))
    if kernel in ("fused_glimpse", "fused_prop", "fused_disc"):
        return (kernel,) + tuple((k, tuple(v) if isinstance(v, list) else v)
                                 for k, v in sorted(shape.items()))
    return (kernel, shape["n"], shape["dx"], shape["units"])


def _forward_spy(calls, name, fn):
    def spy(*args):
        if name == "fused_mlp":
            x, params, acts = args
            shape = dict(n=int(np.prod(x.shape[:-1])), d_in=x.shape[-1],
                         widths=[w.shape[1] for w, _ in params], acts=list(acts))
        else:
            shape = dict(n=args[0].shape[0], dx=args[0].shape[1], units=args[1].shape[1])
        calls[_key(name, shape)] += 1
        return fn(*args)
    return spy


def _glimpse_spy(calls, fn):
    def spy(img, wl, mi, mask_params, enc_params, head_w, head_b, glimpse_size, n_what):
        masked = mi is not None
        shape = dict(n=img.shape[0], img=list(img.shape[1:]), glimpse=list(glimpse_size),
                     d1=enc_params[0][0].shape[1], d2=enc_params[1][0].shape[1],
                     n_what=n_what, d_mi=mi.shape[1] if masked else 0,
                     d_m=mask_params[0][0].shape[1] if masked else 0)
        calls[_key("fused_glimpse", shape)] += 1
        return fn(img, wl, mi, mask_params, enc_params, head_w, head_b, glimpse_size, n_what)
    return spy


def _prop_spy(calls, fn):
    def spy(img, z_tm1, temporal_h, h0, eps_where, eps_what, u_pres, p, glimpse_size):
        S, n, U = temporal_h.shape
        shape = dict(n=n, S=S, img=list(img.shape[1:]), glimpse=list(glimpse_size),
                     n_what=eps_what.shape[-1], U=U, SP=p.sp[0][0].shape[1],
                     WB=p.wb[0][0].shape[1], MH=p.mask[0][0].shape[1])
        calls[_key("fused_prop", shape)] += 1
        return fn(img, z_tm1, temporal_h, h0, eps_where, eps_what, u_pres, p, glimpse_size)
    return spy


def _disc_spy(calls, fn):
    def spy(img, img_flat, conditioning, h0, eps_where, eps_what, u_pres, p, glimpse_size):
        S, n, _ = eps_where.shape
        shape = dict(n=n, S=S, img=list(img.shape[1:]), glimpse=list(glimpse_size),
                     n_what=eps_what.shape[-1], U=p.rnn[1].shape[0], SP=p.sp[0][0].shape[1],
                     C=conditioning.shape[1])
        calls[_key("fused_disc", shape)] += 1
        return fn(img, img_flat, conditioning, h0, eps_where, eps_what, u_pres, p, glimpse_size)
    return spy


def _backward_spy(calls, name, fn):
    def spy(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return spy


@pytest.mark.parametrize("mode,config", _modes())
def test_main_path_shapes_match_the_calls_of_a_step(mode, config, monkeypatch):
    _check_calls_of_a_step(mode, False, monkeypatch, config=config)


@pytest.mark.parametrize("mode,config", _modes())
def test_main_path_shapes_match_the_calls_of_a_step_with_the_glimpse_switch(mode, config,
                                                                            monkeypatch):
    _check_calls_of_a_step(mode, True, monkeypatch, config=config)


@pytest.mark.parametrize("mode,fuse_glimpse,config", _modes(False) + _modes(True))
def test_main_path_shapes_match_the_calls_of_a_step_with_the_cells_switch(
        mode, fuse_glimpse, config, monkeypatch):
    _check_calls_of_a_step(mode, fuse_glimpse, monkeypatch, fuse_cells=True, config=config)


@pytest.mark.parametrize("mode,config", _modes())
def test_main_path_shapes_match_the_calls_of_a_step_with_fused_discovery(mode, config,
                                                                         monkeypatch):
    """Both switches at DISC_FLAGS: discovery fused too (the pedestrian
    configuration's own flags have no early-discovery lever)."""
    _check_calls_of_a_step(mode, True, monkeypatch, fuse_cells=True,
                           flags=DISC_FLAGS if config == "release" else PED_FLAGS, config=config)


@pytest.mark.parametrize("mode", ["full", "train"])
@pytest.mark.parametrize("setting", ["off", "glimpse", "both", "both_disc"])
def test_main_path_shapes_match_the_calls_of_generation(mode, setting, monkeypatch):
    """The rollout's model (generation after frame 1) in each switch
    setting; "both_disc" at DISC_FLAGS, where discovery fuses."""
    flags = dict(DISC_FLAGS if setting == "both_disc" else FLAGS, sample_from_prior=True,
                 generate_after=1)
    _check_calls_of_a_step(mode, setting != "off", monkeypatch,
                           fuse_cells=setting.startswith("both"), flags=flags, generate=True)


@pytest.mark.parametrize("mode", ["full", "train"])
@pytest.mark.parametrize("both", [False, True])
@pytest.mark.parametrize("config", sorted(OPTION_FLAGS))
def test_main_path_shapes_match_the_calls_of_the_conv_model_and_options(mode, both, config,
                                                                         monkeypatch):
    calls = _check_calls_of_a_step(mode, both, monkeypatch, fuse_cells=both,
                                   flags=OPTION_FLAGS[config], config=config)
    refused = {"conv": ("fused_glimpse", "fused_prop", "fused_disc"),
               "lstm": ("fused_prop", "fused_disc"), "coverage": ("fused_disc",)}[config]
    launched = {k[0] for k in calls if isinstance(k, tuple)}
    assert not launched & set(refused)
    assert both == ("fused_glimpse" in launched) or config == "conv"
    assert both == ("fused_prop" in launched) or config != "coverage"


def _check_calls_of_a_step(mode, fuse_glimpse, monkeypatch, fuse_cells=False, flags=FLAGS,
                           config="release", generate=False):
    for name, on in (("SQAIR_FUSE_GLIMPSE", fuse_glimpse), ("SQAIR_FUSE_CELLS", fuse_cells)):
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)
    obs, nums = golden_batch()
    if config == "conv":
        img = (H, H)
        model = conv_mnist_model.load(flags, img, device="cpu", seed=0)
    elif config != "pedestrian":
        img = (H, H)
        model = mlp_mnist_model.load(flags, img, device="cpu", seed=0)
    else:
        flags, img = PED_FLAGS, PED_IMG
        obs = np.ascontiguousarray(obs[..., :img[1]])
        model = pedestrian_model.load(flags, img, device="cpu", seed=0)
    calls = collections.Counter()
    spies = {n: _forward_spy(calls, n, getattr(fused, n)) for n in FORWARD}
    spies.update({n + "_bwd": _backward_spy(calls, n + "_bwd", getattr(fused, n + "_bwd"))
                  for n in FORWARD})
    monkeypatch.setattr(fused_glimpse, "fused_glimpse_encoder",
                        _glimpse_spy(calls, fused_glimpse.fused_glimpse_encoder))
    monkeypatch.setattr(fused_glimpse, "fused_glimpse_bwd", _backward_spy(
        calls, "fused_glimpse_bwd", fused_glimpse.fused_glimpse_bwd))
    monkeypatch.setattr(fused_cells, "fused_prop_ssm",
                        _prop_spy(calls, fused_cells.fused_prop_ssm))
    monkeypatch.setattr(fused_cells, "prop_bwd", _backward_spy(
        calls, "fused_prop_bwd", fused_cells.prop_bwd))
    monkeypatch.setattr(fused_cells, "fused_disc_ssm",
                        _disc_spy(calls, fused_cells.fused_disc_ssm))
    monkeypatch.setattr(fused_cells, "disc_bwd", _backward_spy(
        calls, "fused_disc_bwd", fused_cells.disc_bwd))
    with mock.patch.multiple(fused, **spies):
        target, _ = model.loss_and_metrics(
            torch.from_numpy(obs), GeneratorNoise(torch.Generator().manual_seed(1), "cpu"),
            torch.from_numpy(nums), record_mode=mode)
        if mode == "train":
            target.backward()

    shapes = chip_smoke.main_path_shapes(flags, B, flags["k_particles"], T,
                                         train=mode == "train", img=img,
                                         fuse_glimpse=fuse_glimpse, fuse_cells=fuse_cells,
                                         generate=generate)
    want = collections.Counter()
    for kernel, shape, n_calls in shapes:
        want[_key(kernel, shape)] += n_calls
    assert collections.Counter({k: c for k, c in calls.items() if isinstance(k, tuple)}) == want
    expected = chip_smoke.expected_launches(shapes, 1, backward=mode == "train")
    assert {k: c for k, c in calls.items() if isinstance(k, str)} == {
        k: c for k, c in expected.items() if k.endswith("_bwd")}
    # only the input encoder's input (the frames) carries no gradient; the
    # fused discovery runs the input encoder itself
    no_dx = [s for kn, s, _ in shapes if not chip_smoke.needs_dx(kn, s, img=img)]
    fused_disc = any(kn == "fused_disc" for kn, _, _ in shapes)
    assert fused_disc == (fuse_cells and config in ("release", "pedestrian")
                          and (flags.get("early_disc_logit_scale") == 1.0
                               or config == "pedestrian"))
    assert no_dx == ([] if fused_disc or config == "conv" else
                     [dict(d_in=img[0] * img[1], widths=[32, 32], acts=["elu", "elu"],
                           n=B * 2)])
    return calls
