"""Shared helpers of the tests that hold sqair_tpu_torch to sqair_tpu.

Both packages get the same weights (the flax tree, converted) and the same
noise: ``jax_noise_table`` draws, with jax.random, exactly the noise the
JAX model draws inside ``SequentialAIR`` for a given key, keyed the way the
port asks for it, so the port can replay it.
"""
import contextlib
import copy
import functools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sqair_tpu.models import AIRDecoder as JAIRDecoder
from sqair_tpu.models import SQAIRTimestep as JTimestep
from sqair_tpu.ops import fused as jfused
from sqair_tpu.ops import fused_cells as jfused_cells
from sqair_tpu_torch.models import AIRDecoder, SequentialAIR, SQAIRTimestep
from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
from sqair_tpu_torch.training import make_eval_step

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

# the golden config of tests/test_golden.py
B, T, S, H, G, NWHAT, NH = 4, 3, 2, 24, 8, 8, 32
SPH = [16]
# the switch-on step tests' gradient tolerance (test_torch_cells_step.py)
STEP_GRAD_TOL = 1e-4


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


def jax_noise_table(rng, n_frames, n_slots, n_rows, n_what, fused_prop=False,
                    fused_disc=False, prior=False, rec_where_prior=True):
    """The noise of sqair_tpu's SequentialAIR(rng) under the port's keys
    (t, "prop"|"disc", slot, "where"|"what"|"presence").

    :param fused_prop, fused_disc: the propagation / discovery noise as the
        JAX package's fused path (SQAIR_FUSE_CELLS) draws it: slot-major
        [S, B, d] from ``jax.random.split(rng, 3)`` of the module's key, each
        slot's row under its key
    :param prior: also the prior samples of ``sample_from_prior``, under
        (t, "prop"|"disc", "prior", ...): propagation's what, where and
        presence from ``split(split(rng_prop)[0], 3)``; discovery's what
        and where from ``split(split(rng_disc)[0], 4)[:2]``, the recurrent
        where prior's step i under ``fold_in(key, i)`` (key ("where", i)),
        else one [B, S, 4] draw
    """
    table = {}

    def slot_major(key, prefix):
        r = jax.random.split(key, 3)
        draws = (("where", np.asarray(jax.random.normal(r[0], (n_slots, n_rows, 4)))),
                 ("what", np.asarray(jax.random.normal(r[1], (n_slots, n_rows, n_what)))),
                 ("presence", np.asarray(jax.random.uniform(r[2], (n_slots, n_rows, 1)))))
        for name, v in draws:
            for k in range(n_slots):
                table[prefix + (k, name)] = v[k]

    def slot(key, prefix):
        r = jax.random.split(key, 3)
        table[prefix + ("where",)] = np.asarray(jax.random.normal(r[0], (n_rows, 4)))
        table[prefix + ("what",)] = np.asarray(jax.random.normal(r[1], (n_rows, n_what)))
        table[prefix + ("presence",)] = np.asarray(jax.random.uniform(r[2], (n_rows, 1)))

    step_rngs = jax.random.split(rng, n_frames)
    for t in range(n_frames):
        rng_prop, rng_disc = jax.random.split(step_rngs[t])
        for kind, key, fused in (("prop", jax.random.split(rng_prop)[1], fused_prop),
                                 ("disc", jax.random.split(rng_disc)[1], fused_disc)):
            if fused:
                slot_major(key, (t, kind))
            else:
                for k in range(n_slots):
                    slot(jax.random.fold_in(key, k), (t, kind, k))
        if prior:
            rows = (n_rows, n_slots)
            r = jax.random.split(jax.random.split(rng_prop)[0], 3)
            table[(t, "prop", "prior", "what")] = np.asarray(
                jax.random.normal(r[0], rows + (n_what,)))
            table[(t, "prop", "prior", "where")] = np.asarray(jax.random.normal(r[1], rows + (4,)))
            table[(t, "prop", "prior", "presence")] = np.asarray(jax.random.uniform(r[2], rows))
            r = jax.random.split(jax.random.split(rng_disc)[0], 4)
            table[(t, "disc", "prior", "what")] = np.asarray(
                jax.random.normal(r[0], rows + (n_what,)))
            if rec_where_prior:
                for i in range(n_slots):
                    table[(t, "disc", "prior", "where", i)] = np.asarray(
                        jax.random.normal(jax.random.fold_in(r[1], i), (n_rows, 4)))
            else:
                table[(t, "disc", "prior", "where")] = np.asarray(
                    jax.random.normal(r[1], rows + (4,)))
    return table


def jax_resample_noise(rng, n_examples, k):
    """{("resample",): the uniform [B, k] of the resampling draw of
    sqair_tpu's ``Model.loss_and_metrics(params, rng, ...)``}:
    ``jax.random.categorical(fold_in(rng, 0x5e5a), ...)`` is the Gumbel-max
    draw over ``uniform(key, (B, k), minval=tiny, maxval=1)``."""
    key = jax.random.fold_in(rng, 0x5E5A)
    u = jax.random.uniform(key, (n_examples, k), minval=np.finfo(np.float32).tiny, maxval=1.0)
    return {("resample",): np.asarray(u)}


def near_tie_frame(sites, table):
    """The first frame with a presence draw whose uniform lies within
    chip_smoke.FLIP_MARGIN of its probability in the port's run, or None:
    from there on a run of other numerics (JAX's) may draw another presence.

    :param sites: ``chip_smoke.presence_sites`` of the port's run
    :param table: the noise it ran with
    """
    for t in sorted(sites):
        for key, u in chip_smoke.site_uniforms(table, t, sites[t]["prop"].shape[-1]).items():
            if np.any(np.abs(u - sites[t][key]) < chip_smoke.FLIP_MARGIN):
                return t
    return None


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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tests with one torch intra-op thread (an autouse fixture
    for the modules that import it): the tier-1 command runs six test
    processes on the machine's cores, and torch's default of a thread per
    core in each made them wait on each other, several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# ------------------------------------------ the switch-on step tests' helpers
def spy(mp, module, name):
    """Counts the calls of module.name (for JAX: while tracing)."""
    calls = []
    real = getattr(module, name)
    mp.setattr(module, name, lambda *a: calls.append(1) or real(*a))
    return calls


def port_noise_table(model, obs, nums):
    """The port's own noise for one step, drawn with every switch off."""
    noise = GeneratorNoise(torch.Generator().manual_seed(3), "cpu", record=True)
    make_eval_step(model)(obs, nums, noise)
    # out of the eval step's inference mode, for autograd
    return {key: v.clone() for key, v in noise.table.items()}


def step_grads(model, obs, nums, noise):
    """(every parameter's gradient, aux) of one train-record loss."""
    model.sequence.zero_grad(set_to_none=True)
    target, aux = model.loss_and_metrics(torch.from_numpy(obs), noise, torch.from_numpy(nums),
                                         record_mode="train")
    target.backward()
    out = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
           for n, p in model.sequence.named_parameters()}
    model.sequence.zero_grad(set_to_none=True)
    return out, aux


def f64_step_grads(model, obs, nums, table):
    """The same step's gradients with the model and the noise in float64."""
    m64 = copy.copy(model)
    m64.sequence = copy.deepcopy(model.sequence).double()
    return step_grads(m64, obs.astype(np.float64), nums.astype(np.float64),
                      ReplayNoise(table, "cpu", dtype=torch.float64))[0]


def step_grad_close(got, want, g64, name):
    """|got - want| <= max(STEP_GRAD_TOL max|want| + 1e-7, 2 max|want - g64|)."""
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    f32_noise = float(np.max(np.abs(want - g64.numpy()))) if want.size else 0.0
    tol = max(STEP_GRAD_TOL * float(np.max(np.abs(want))) + 1e-7, 2.0 * f32_noise)
    assert err <= tol, f"d{name}: {err:.3g} > {tol:.3g}"
