"""Shared helpers of the tests that hold sqair_tpu_torch to sqair_tpu.

Both packages get the same weights (the flax tree, converted) and the same
noise: ``jax_noise_table`` draws, with jax.random, exactly the noise the
JAX model draws inside ``SequentialAIR`` for a given key, keyed the way the
port asks for it, so the port can replay it.
"""
import contextlib
import functools

import jax
import numpy as np
import pytest

from sqair_tpu.models import AIRDecoder as JAIRDecoder
from sqair_tpu.models import SQAIRTimestep as JTimestep
from sqair_tpu.ops import fused as jfused
from sqair_tpu.ops import fused_cells as jfused_cells
from sqair_tpu_torch.models import AIRDecoder, SequentialAIR, SQAIRTimestep

# the golden config of tests/test_golden.py
B, T, S, H, G, NWHAT, NH = 4, 3, 2, 24, 8, 8, 32
SPH = [16]


def _kwargs(**over):
    kw = dict(n_steps=S, img_size=(H, H), glimpse_size=(G, G), n_what=NWHAT,
              n_hidden=NH, steps_pred_hidden=SPH)
    kw.update(over)
    return kw


def build_pair(**timestep_kwargs):
    """(jax timestep, jax decoder, port SequentialAIR) at the golden widths."""
    jts = JTimestep(**_kwargs(**timestep_kwargs))
    mean = np.zeros((H, H), np.float32)
    jdec = JAIRDecoder(img_size=(H, H), glimpse_size=(G, G), glimpse_n_hiddens=[NH],
                       mean_img=mean)
    ts = SQAIRTimestep(**_kwargs(**timestep_kwargs))
    dec = AIRDecoder(img_size=(H, H), glimpse_size=(G, G), n_what=NWHAT,
                     glimpse_n_hiddens=[NH], mean_img=mean)
    return jts, jdec, SequentialAIR(ts, dec)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_noise_table(rng, n_frames, n_slots, n_rows, n_what, fused_prop=False):
    """The noise of sqair_tpu's SequentialAIR(rng) under the port's keys
    (t, "prop"|"disc", slot, "where"|"what"|"presence").

    :param fused_prop: the propagation noise as the JAX package's fused
        propagation path (SQAIR_FUSE_CELLS) draws it: slot-major [S, B, d]
        from ``jax.random.split(ssm_rng, 3)``, each slot's row under its key
    """
    table = {}

    def slot_major(key, t):
        r = jax.random.split(key, 3)
        draws = (("where", np.asarray(jax.random.normal(r[0], (n_slots, n_rows, 4)))),
                 ("what", np.asarray(jax.random.normal(r[1], (n_slots, n_rows, n_what)))),
                 ("presence", np.asarray(jax.random.uniform(r[2], (n_slots, n_rows, 1)))))
        for name, v in draws:
            for k in range(n_slots):
                table[(t, "prop", k, name)] = v[k]

    def slot(key, prefix):
        r = jax.random.split(key, 3)
        table[prefix + ("where",)] = np.asarray(jax.random.normal(r[0], (n_rows, 4)))
        table[prefix + ("what",)] = np.asarray(jax.random.normal(r[1], (n_rows, n_what)))
        table[prefix + ("presence",)] = np.asarray(jax.random.uniform(r[2], (n_rows, 1)))

    step_rngs = jax.random.split(rng, n_frames)
    for t in range(n_frames):
        rng_prop, rng_disc = jax.random.split(step_rngs[t])
        ssm_rng = jax.random.split(rng_prop)[1]
        disc_rng = jax.random.split(rng_disc)[1]
        if fused_prop:
            slot_major(ssm_rng, t)
        for k in range(n_slots):
            if not fused_prop:
                slot(jax.random.fold_in(ssm_rng, k), (t, "prop", k))
            slot(jax.random.fold_in(disc_rng, k), (t, "disc", k))
    return table


def assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want) / (np.abs(want) + 1.0)) if got.size else 0.0
    assert err <= tol, f"{what}: max scaled error {err:.3g} > {tol}"


def golden_batch():
    """(obs [T, B, H, H], nums [T, B, S + 1]): frames with structure, two
    bright squares on a dim background, and their counts."""
    rs = np.random.default_rng(5)
    obs = (rs.uniform(size=(T, B, H, H)) * 0.2).astype(np.float32)
    obs[:, :, 4:12, 5:13] += 0.8
    obs[:, 1::2, 14:22, 12:20] += 0.8
    nums = np.zeros((T, B, S + 1), np.float32)
    nums[:, :, 0] = 1
    nums[:, 1::2, 1] = 1
    return obs, nums


@contextlib.contextmanager
def tpu_kernels_interpreted():
    """sqair_tpu's main path as on the TPU: its Pallas kernels and their
    hand-written backward kernels, run in interpret mode on the CPU (as
    tests/test_fused_rnn_kernels.py runs them).  Its gradients differ from
    the jnp reference's at a pre-activation of exactly 0, where the
    reference's elu derivative is 0.5 and the kernel's is 1
    (tests/test_torch_fused_bwd.py)."""
    from jax.experimental import pallas

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call",
                   functools.partial(pallas.pallas_call, interpret=True))
        mp.setattr(jfused, "use_pallas", lambda: True)
        # the frame kernels pass their own interpret flag
        mp.setattr(jfused_cells, "_INTERPRET", True)
        yield
