"""Common flags used by model configurations (the port of
sqair_tpu/common_model_flags.py: the same names, types and defaults)."""
from __future__ import annotations

from .experiment import flags

DEFAULTS = flags.define_all((
    (float, "transform_var_bias", -3.0,
     "Bias added to the variance logit of Gaussian `where` distributions."),
    (float, "output_scale", 0.25, "Scales the output mean of the glimpse decoder."),
    (str, "scale_prior", "-2",
     "One float or four comma-separated floats: mean of the Gaussian prior for the "
     "scale logit."),
    (int, "glimpse_size", 20, "Glimpse size."),
    (float, "prop_prior_step_bias", 10.0, ""),
    (str, "prop_prior_type", "rnn", "Choose from {rnn, rw, guided}."),
    (bool, "masked_glimpse", True,
     "Masks glimpses based on the temporal state in propagation."),
    (int, "k_particles", 5, "Number of IWAE particles."),
    (int, "n_steps_per_image", 3, "Number of inference steps per frame."),
    (str, "transition", "VanillaRNN", "RNN cell for discovery and propagation cores."),
    (str, "time_transition", "GRU", "RNN cell for the temporal rnn."),
    (str, "prior_transition", "GRU", "RNN cell for the propagation prior."),
    (float, "output_std", 0.3, "Std dev of Gaussian p(x|z)."),
    (int, "n_units", 8, "Hidden width in units of 32 neurons (8 -> 256)."),
    (int, "n_what", 50, "Dimensionality of `what` variables."),
    (float, "aspect_penalty", 0.0,
     "Weight of a squared-log-aspect-ratio penalty on present glimpses. 0 disables."),
))
