"""Generation from the prior: sqair_tpu_torch's SequentialAIR under
``sample_from_prior`` with ``generate_after`` 1 (frames 2 and 3 of 4
generated) held to sqair_tpu's, at the golden widths (B=4, k=2, S=2, 24x24
frames, 8x8 glimpses, 32 wide), the JAX weights converted and the JAX
model's noise replayed, its prior samples included
(``jax_noise_table(..., prior=True)``).  Every field of the full record and
of the trimmed "train" record (which keeps its log-probs and decode in the
loop under sample_from_prior), with the recurrent where prior and with the
fixed one, with no switch and with both switches (the port's plain
versions against JAX's Pallas kernels in interpret mode; at these widths
discovery fuses too).

Tolerance 1e-4 on |a - b| / (|b| + 1), as the eval step's: f32 on both
sides over T x 2S dependent cell steps.  A presence draw whose uniform lies
within chip_smoke.FLIP_MARGIN (1e-4) of its probability may come out
otherwise under other f32 roundings; frames from the first such draw on
(``torch_parity.near_tie_frame``, from the port's probabilities) are not
gated, and the test asserts that a generated frame is gated.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu_torch.convert import load_flax_params
from sqair_tpu_torch.models import Model, SequentialAIR
from sqair_tpu_torch.nn.layers import init_params
from sqair_tpu_torch.nn.stochastic import (ConditionedNormalAdaptor, RecurrentNormal,
                                           RecurrentNormalImpl)
from sqair_tpu_torch.ops import distributions as D
from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
from torch_parity import (B, H, NWHAT, S, assert_close, build_pair, jax_noise_table,
                          near_tie_frame, to_numpy, tpu_kernels_interpreted)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

TOL = 1e-4
T, K, GENERATE_AFTER = 4, 2, 1
SWITCHES = {"off": {}, "both": {"SQAIR_FUSE_CELLS": "1", "SQAIR_FUSE_GLIMPSE": "1"}}


def _batch():
    rs = np.random.default_rng(7)
    obs = (rs.uniform(size=(T, B, H, H)) * 0.2).astype(np.float32)
    obs[:, :, 4:12, 5:13] += 0.8
    obs[:, 1::2, 14:22, 12:20] += 0.8
    return obs


def _pair(rec_where_prior):
    jts, jdec, seq = build_pair(rec_where_prior=rec_where_prior)
    jmodel = JModel(JSequentialAIR(jts, jdec, sample_from_prior=True,
                                   generate_after=GENERATE_AFTER), k_particles=K)
    obs = _batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    seq = SequentialAIR(seq.timestep, seq.decoder, sample_from_prior=True,
                        generate_after=GENERATE_AFTER)
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=K)
    return jmodel, params, model, obs


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("rec_where_prior", [True, False], ids=["rec_where", "fixed_where"])
def test_generation_records_match_jax(rec_where_prior, switch):
    jmodel, params, model, obs = _pair(rec_where_prior)
    rng = jax.random.PRNGKey(3)
    fused = switch == "both"
    table = jax_noise_table(rng, T, S, B * K, NWHAT, fused_prop=fused, fused_disc=fused,
                            prior=True, rec_where_prior=rec_where_prior)
    with pytest.MonkeyPatch.context() as mp, tpu_kernels_interpreted():
        for name, value in SWITCHES[switch].items():
            mp.setenv(name, value)
        for mode in ("full", "train"):
            fwd = jax.jit(lambda p, r, o: jmodel.forward(p, r, o, record_mode=mode))
            want = to_numpy(fwd(params, rng, jnp.asarray(obs)))
            with torch.inference_mode(), chip_smoke.presence_sites(torch, model) as sites:
                got = model.forward(torch.from_numpy(obs), ReplayNoise(table, "cpu"), mode)
            got = {key: v.numpy() for key, v in got.items()}
            assert sorted(got) == sorted(want), mode
            gated = near_tie_frame(sites, table)
            gated = T if gated is None else gated
            assert gated > GENERATE_AFTER + 1, f"{mode}: only frames [0, {gated}) gated"
            for key in sorted(want):
                assert_close(got[key][:gated], want[key][:gated], TOL, f"{mode} {key}")
            if mode == "full":
                # discovery's presence is 0 in every generated frame
                assert not got["disc_pres"][GENERATE_AFTER + 1:].any()


@pytest.mark.parametrize("rec_where_prior", [True, False], ids=["rec_where", "fixed_where"])
def test_timestep_prior_samples_match_jax(rec_where_prior):
    """One inferred frame, then one generated frame, through both packages'
    timestep: every output of propagation and discovery before the merge
    (the record keeps neither module's own samples, and drops discovery's
    generated slots, which are absent), the merged latents and the log-probs."""
    from sqair_tpu.models import SQAIRTimestep as JTimestep

    jmodel, params, model, obs = _pair(rec_where_prior)
    jts, ts = jmodel.sequence.timestep, model.sequence.timestep
    p = params["timestep"]
    rows = B * K
    img = np.repeat(obs[:2], K, axis=1)
    jcarry = jts.apply(p, rows, method=JTimestep.initial_carry)
    carry = ts.initial_carry(rows, "cpu")
    step = jax.jit(lambda c, r, im, t, dg: jts.apply(
        p, r, im, c["z"], c["time_state"], c["prior_state"], c["last_used_id"],
        c["prev_ids"], t, True, dg))
    for t, dg in ((0, 0.0), (1, 1.0)):
        rng = jax.random.PRNGKey(10 + t)
        table = jax_noise_table(rng, 1, S, rows, NWHAT, prior=True,
                                rec_where_prior=rec_where_prior)
        want = to_numpy(step(jcarry, jax.random.split(rng, 1)[0], jnp.asarray(img[t]), t,
                             jnp.asarray(dg, jnp.float32)))
        with torch.inference_mode():
            got = ts(torch.from_numpy(img[t]), carry["z"], carry["time_state"],
                     carry["prior_state"], carry["last_used_id"], carry["prev_ids"], t,
                     ReplayNoise(table, "cpu").scope(0), sample_from_prior=True,
                     do_generate=dg)
        for module in ("prop", "disc"):
            for key, v in want[module].items():
                if key == "max_disc_steps":
                    continue  # a constant the JAX model never reads; not ported
                if isinstance(v, dict):
                    for field, x in v.items():
                        assert_close(got[module][key][field].numpy(), x, TOL,
                                     f"t={t} {module} {key}.{field}")
                elif isinstance(v, np.ndarray):
                    assert_close(got[module][key].numpy(), v, TOL, f"t={t} {module} {key}")
        for i, x in enumerate(want["z_t"]):
            assert_close(got["z_t"][i].numpy(), x, TOL, f"t={t} z_t[{i}]")
        for key in ("p_z", "q_z_given_x", "presence_log_prob"):
            assert_close(got[key].numpy(), want[key], TOL, f"t={t} {key}")
        jcarry = dict(z=want["z_t"], time_state=want["temporal_hidden_state"],
                      prior_state=want["prop_prior_state"], prev_ids=want["ids"],
                      last_used_id=want["highest_used_ids"])
        carry = dict(z=got["z_t"], time_state=got["temporal_hidden_state"],
                     prior_state=got["prop_prior_state"], prev_ids=got["ids"],
                     last_used_id=got["highest_used_ids"])


def test_recurrent_normal_sampler_and_adaptors():
    """The where prior's sampler feeds each sample back: its samples' log-prob
    equals each step's Normal at the sample; the fixed prior's adaptor draws
    once under its key and ignores the conditioning."""
    impl = RecurrentNormalImpl(4, 16, d_cond=3)
    init_params(impl, torch.Generator().manual_seed(0))
    cond = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
    noise = GeneratorNoise(torch.Generator().manual_seed(2), "cpu", record=True)
    dist = RecurrentNormal(impl)
    samples = dist.sample(noise, "where", (5, 3), conditioning=cond)
    assert samples.shape == (5, 3, 4)
    assert sorted(noise.table) == [("where", 0), ("where", 1), ("where", 2)]
    # replayed, the same samples; their log-probs are finite and the sampler's
    again = impl.sample(ReplayNoise(noise.table, "cpu").scope("where"), 5, 3, cond)
    assert torch.equal(again, samples)
    lp = dist.log_prob(samples, conditioning=cond)
    sample, state = impl._initial(5, cond)
    want = []
    for i in range(3):
        pdf, state = impl._step(sample, state)
        sample = samples[:, i]
        want.append(pdf.log_prob(sample))
    assert torch.equal(lp, torch.stack(want, 1))
    adaptor = ConditionedNormalAdaptor(torch.zeros(2), torch.full((2,), 2.0))
    eps = torch.tensor([[0.5, -1.0]])
    drawn = adaptor.sample(ReplayNoise({("where",): eps}, "cpu"), "where", (1,),
                           conditioning=cond)
    assert torch.equal(drawn, 2.0 * eps)
    assert torch.equal(adaptor.log_prob(eps, conditioning=cond),
                       D.Normal(torch.zeros(2), torch.full((2,), 2.0)).log_prob(eps))
