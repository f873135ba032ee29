"""MLP-SQAIR built from a flags dict (the port of
sqair_tpu/configs/mlp_mnist_model.py and common_model_flags.py).

``load(flags, img_shape)`` takes the flags as a dict, e.g. a parsed
``flags.json`` of a run of the JAX package; a missing flag, or one that is
null (a run that predates the flag), takes the JAX package's default.
``train_settings(flags)`` reads the training flags and
``make_optimizer(flags)`` builds the optimizer they name.  Importing the
module defines the model's flags in the port's registry
(``experiment/flags.py``), from the same tables as ``DEFAULTS``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .. import common_model_flags
from ..device import resolve_device
from ..experiment import flags
from ..models import AIRDecoder, Model, SequentialAIR, SQAIRTimestep
from ..nn.layers import init_params
from ..training import train as training

# the training flags the model config reads (sqair_tpu/scripts/experiment.py
# defines them; the port's CLI defines them from this table)
TRAIN_DEFAULTS = dict(opt="rmsprop", learning_rate=1e-5, schedule="4,6,10",
                      train_itr=int(2e6), l2=0.0)

# the model config's own flags (sqair_tpu/configs/mlp_mnist_model.py), defined
# under the JAX package's names and defaults
MODEL_DEFAULTS = flags.define_all((
    (str, "disc_prior_type", "cat", "Prior for #discovery steps: {geom, cat}."),
    (float, "step_success_prob", 0.75,
     "Step success prob for the geometric discovery prior."),
    (float, "disc_step_bias", 1.0, "Added to the logit of discovering a new object."),
    (float, "prop_step_bias", 5.0, "Added to the logit of propagating an existing object."),
    (float, "early_disc_step_bias", 0.0,
     "Extra per-object prior cost (nats) on discovery counts for frames t < "
     "early_disc_horizon (0 = off)."),
    (int, "early_disc_horizon", 2, "Frames the early discovery suppression applies to."),
    (float, "early_disc_logit_bias", 0.0,
     "Subtracted from the discovery presence logit for frames t < early_disc_horizon "
     "(0 = off)."),
    (float, "transient_disc_penalty", 0.0,
     "Weight of the transient-discovery penalty: expected counts at frames t < "
     "early_disc_horizon in excess of the count at t = horizon, in nats each."),
    (float, "transient_penalty_temp", 1.0,
     "Temperature of the sigmoid inside the transient penalty (1 = exact expected "
     "counts)."),
    (float, "early_disc_logit_scale", 1.0,
     "Multiplies the discovery presence logit for frames t < early_disc_horizon "
     "(1 = off)."),
    (float, "early_disc_logit_clamp", 0.0,
     "Straight-through |logit| cap on the discovery presence logit for frames t < "
     "early_disc_horizon (0 = off)."),
    (bool, "disc_coverage_signal", False,
     "Feed the discovery steps predictor an explained-so-far coverage signal: a "
     "low-res ST crop of a canvas of the propagated boxes and this frame's earlier "
     "discoveries (adds 16 first-layer rows: warm-start old checkpoints with "
     "tools/pad_coverage_params_torch.py)."),
    (float, "coverage_lr_mult", 1.0,
     "Update multiplier for the 16 coverage input-rows of the discovery steps "
     "predictor (requires --disc_coverage_signal; 1 = off)."),
    (bool, "sample_from_prior", False, "Sample from the prior instead of q."),
    (bool, "rec_where_prior", True, "Recurrent prior for where in discovery."),
    (int, "generate_after", -1,
     "Switch to generation after this frame (if >= 0)."),
))

# every flag the model reads, at the JAX package's defaults
DEFAULTS = dict(common_model_flags.DEFAULTS, **MODEL_DEFAULTS)


def given(flags: Mapping) -> dict:
    """The flags that have a value: a null in a flags.json means the run
    predates the flag, which then takes its default."""
    return {k: v for k, v in flags.items() if v is not None}


def parse_string_flag(flag, num_elements=-1):
    """'a,b' -> [a, b]; one value is repeated num_elements times."""
    try:
        values = [float(f.strip()) for f in str(flag).split(",")]
    except ValueError:
        values = [float(flag)]
    if len(values) == 1 and num_elements > 1:
        values = values * num_elements
    elif num_elements != -1 and len(values) != num_elements:
        raise ValueError(f'Incorrect number of elements in flag "{flag}"')
    return values


def get_params(F: Mapping):
    n_hidden = 32 * int(F["n_units"])
    return dict(glimpse_size=[int(F["glimpse_size"])] * 2, n_hidden=n_hidden, n_layers=2,
                n_hiddens=[n_hidden] * 2, steps_pred_hidden=[n_hidden // 2])


def load(flags: Mapping, img_shape: Sequence[int], mean_img: Optional[np.ndarray] = None,
         device="cuda", seed: int = 0, **param_overrides) -> Model:
    """Builds the model with weights drawn from ``seed``.

    :param flags: flag values by name
    :param img_shape: (H, W) of a frame
    :param mean_img: [H, W] background added where nothing is written
    :param param_overrides: overrides of ``get_params`` entries, for config
        variants (e.g. the pedestrian config's non-square glimpse_size
        [gh, gw])
    """
    F = resolved(flags)
    params = get_params(F)
    params.update(param_overrides)
    return assemble(
        F, img_shape, params, mean_img, device, seed,
        timestep=dict(early_disc_step_bias=F["early_disc_step_bias"],
                      early_disc_horizon=int(F["early_disc_horizon"]),
                      early_disc_logit_bias=F["early_disc_logit_bias"],
                      early_disc_logit_scale=F["early_disc_logit_scale"],
                      early_disc_logit_clamp=F["early_disc_logit_clamp"],
                      disc_coverage_signal=bool(F["disc_coverage_signal"])),
        model=dict(transient_penalty=F["transient_disc_penalty"],
                   transient_horizon=int(F["early_disc_horizon"]),
                   transient_temp=F["transient_penalty_temp"]))


def resolved(flags: Mapping) -> dict:
    """Every flag the model reads: the given ones, the rest at the JAX
    package's defaults."""
    F = dict(DEFAULTS)
    F.update(given(flags))
    return F


def assemble(F: Mapping, img_shape: Sequence[int], params: Mapping,
             mean_img: Optional[np.ndarray], device, seed: int, timestep: Mapping = (),
             decoder: Mapping = (), model: Mapping = ()) -> Model:
    """The model of the flags ``F`` and the sizes ``params`` (``get_params``),
    with the config's own ``SQAIRTimestep``, ``AIRDecoder`` and ``Model``
    arguments, weights drawn from ``seed``, on ``device``."""
    device = resolve_device(device)
    img_size = tuple(int(s) for s in img_shape)
    ts = SQAIRTimestep(
        n_steps=int(F["n_steps_per_image"]), img_size=img_size,
        glimpse_size=tuple(params["glimpse_size"]), n_what=int(F["n_what"]),
        n_hidden=params["n_hidden"], n_layers=params["n_layers"],
        steps_pred_hidden=tuple(params["steps_pred_hidden"]),
        transition=F["transition"], time_transition=F["time_transition"],
        prior_transition=F["prior_transition"],
        transform_var_bias=F["transform_var_bias"], disc_step_bias=F["disc_step_bias"],
        prop_step_bias=F["prop_step_bias"], prop_prior_step_bias=F["prop_prior_step_bias"],
        prop_prior_type=F["prop_prior_type"], step_success_prob=F["step_success_prob"],
        disc_prior_type=F["disc_prior_type"], rec_where_prior=F["rec_where_prior"],
        scale_prior=tuple(parse_string_flag(F["scale_prior"], num_elements=2)),
        masked_glimpse=F["masked_glimpse"], **dict(timestep))
    dec = AIRDecoder(
        img_size=img_size, glimpse_size=tuple(params["glimpse_size"]),
        n_what=int(F["n_what"]), glimpse_n_hiddens=tuple(params["n_hiddens"]),
        glimpse_output_scale=F["output_scale"], mean_img=mean_img,
        output_std=F["output_std"], **dict(decoder))
    seq = SequentialAIR(ts, dec, sample_from_prior=bool(F["sample_from_prior"]),
                        generate_after=int(F["generate_after"]))
    init_params(seq, torch.Generator().manual_seed(seed))
    seq.to(device)
    return Model(seq, k_particles=int(F["k_particles"]), aspect_penalty=F["aspect_penalty"],
                 **dict(model))


def train_settings(flags: Mapping) -> dict:
    """The training flags (opt, learning_rate, schedule, train_itr, l2),
    missing ones at the JAX package's defaults.  Raises on an unknown
    optimizer."""
    F = dict(TRAIN_DEFAULTS)
    F.update({k: v for k, v in given(flags).items() if k in TRAIN_DEFAULTS})
    if str(F["opt"]).lower() not in training.OPTIMIZERS:
        raise ValueError(f"Unknown optimizer '{F['opt']}' "
                         f"(choose from {sorted(training.OPTIMIZERS)})")
    return dict(opt=str(F["opt"]), learning_rate=float(F["learning_rate"]),
                schedule=str(F["schedule"] or ""), train_itr=int(F["train_itr"]),
                l2=float(F["l2"]))


def make_optimizer(flags: Mapping):
    """The optimizer factory (params -> optimizer) and the L2 weight of the
    flags: ``opt`` at ``learning_rate``, decayed by ``schedule`` over
    ``train_itr``."""
    s = train_settings(flags)
    lr = training.make_lr_schedule(s["learning_rate"], s["schedule"], s["train_itr"])
    return training.make_optimizer(s["opt"], lr), s["l2"]
