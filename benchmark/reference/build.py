"""The plain model of a configuration file's flags (a frozen copy of the
program's ``configs/mlp_mnist_model.py`` and ``configs/conv_mnist_model.py``
model assembly, without the flag registry)."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .models import AIRDecoder, Model, SequentialAIR, SQAIRTimestep


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


def build_model(kind: str, F: Mapping, img_size: Sequence[int], device,
                mean_img: np.ndarray) -> Model:
    """The model ("mlp" or "conv") of the flags ``F`` with the background
    ``mean_img`` [H, W], its parameters uninitialised (the benchmark's
    weight maker fills them)."""
    n_hidden = 32 * int(F["n_units"])
    glimpse_size = (int(F["glimpse_size"]),) * 2
    img_size = tuple(int(s) for s in img_size)
    if kind == "mlp":
        timestep = dict(early_disc_step_bias=F["early_disc_step_bias"],
                        early_disc_horizon=int(F["early_disc_horizon"]),
                        early_disc_logit_bias=F["early_disc_logit_bias"],
                        early_disc_logit_scale=F["early_disc_logit_scale"],
                        early_disc_logit_clamp=F["early_disc_logit_clamp"],
                        disc_coverage_signal=bool(F["disc_coverage_signal"]))
        decoder = {}
        model = dict(transient_penalty=F["transient_disc_penalty"],
                     transient_horizon=int(F["early_disc_horizon"]),
                     transient_temp=F["transient_penalty_temp"])
    elif kind == "conv":
        channels = tuple(int(c) for c in str(F["conv_channels"]).split(","))
        timestep = dict(encoder_type="conv", conv_channels=channels,
                        conv_kernel=int(F["conv_kernel"]))
        decoder = dict(decoder_type="subpixel")
        model = {}
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    ts = SQAIRTimestep(
        n_steps=int(F["n_steps_per_image"]), img_size=img_size, glimpse_size=glimpse_size,
        n_what=int(F["n_what"]), n_hidden=n_hidden, n_layers=2,
        steps_pred_hidden=(n_hidden // 2,), transition=F["transition"],
        time_transition=F["time_transition"], prior_transition=F["prior_transition"],
        transform_var_bias=F["transform_var_bias"], disc_step_bias=F["disc_step_bias"],
        prop_step_bias=F["prop_step_bias"], prop_prior_step_bias=F["prop_prior_step_bias"],
        prop_prior_type=F["prop_prior_type"], step_success_prob=F["step_success_prob"],
        disc_prior_type=F["disc_prior_type"], rec_where_prior=F["rec_where_prior"],
        scale_prior=tuple(parse_string_flag(F["scale_prior"], num_elements=2)),
        masked_glimpse=F["masked_glimpse"], **timestep)
    dec = AIRDecoder(img_size=img_size, glimpse_size=glimpse_size, n_what=int(F["n_what"]),
                     glimpse_n_hiddens=(n_hidden, n_hidden),
                     glimpse_output_scale=F["output_scale"], mean_img=mean_img,
                     output_std=F["output_std"], **decoder)
    seq = SequentialAIR(ts, dec, sample_from_prior=bool(F["sample_from_prior"]),
                        generate_after=int(F["generate_after"]))
    seq.to(torch.device(device))
    return Model(seq, k_particles=int(F["k_particles"]), aspect_penalty=F["aspect_penalty"],
                 **model)
