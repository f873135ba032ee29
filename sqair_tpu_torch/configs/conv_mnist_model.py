"""Conv-SQAIR model config (the port of sqair_tpu/configs/conv_mnist_model.py):
ConvEncoder input and glimpse encoders and a SubpixelDecoder glimpse
decoder.

The whole ``mlp_mnist_model`` flag surface plus ``conv_kernel`` and
``conv_channels``, under the JAX package's names and defaults.  As the JAX
package's config, it leaves the early-discovery levers, the coverage signal
and the transient penalty at the modules' defaults, whatever the flags say.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from ..experiment import flags
from ..models import Model
from . import mlp_mnist_model
from .mlp_mnist_model import make_optimizer, train_settings  # noqa: F401 (config contract)

CONV_DEFAULTS = flags.define_all((
    (int, "conv_kernel", 3, "Conv kernel size."),
    (str, "conv_channels", "32,64", "Channels per conv layer."),
))


def load(flags: Mapping, img_shape: Sequence[int], mean_img: Optional[np.ndarray] = None,
         device="cuda", seed: int = 0, **param_overrides) -> Model:
    """Builds the conv model with weights drawn from ``seed`` (the contract
    of ``mlp_mnist_model.load``)."""
    F = mlp_mnist_model.resolved(flags)
    F = dict(CONV_DEFAULTS, **F)
    params = mlp_mnist_model.get_params(F)
    params.update(param_overrides)
    channels = tuple(int(c) for c in str(F["conv_channels"]).split(","))
    return mlp_mnist_model.assemble(
        F, img_shape, params, mean_img, device, seed,
        timestep=dict(encoder_type="conv", conv_channels=channels,
                      conv_kernel=int(F["conv_kernel"])),
        decoder=dict(decoder_type="subpixel"))
