"""DiscoveryCore and PropagationCore of sqair_tpu_torch held to sqair_tpu on
one frame: the slot unrolls Discover._discover and Propagate._ssm at the
golden config, with the JAX weights converted and the JAX noise backed out
of its outputs.

Tolerance 5e-5 on |a - b| / (|b| + 1): f32 on both sides, through three
dependent slot steps of MLPs, cells and bilinear crops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu_torch.convert import load_flax_params
from sqair_tpu_torch.models import HIDDEN_OUTPUT_FIELDS
from sqair_tpu_torch.ops.noise import ReplayNoise
from torch_parity import B, H, NH, NWHAT, S, assert_close, build_pair, to_numpy

TOL = 5e-5


def _uniform_from(presence, prob):
    """A uniform draw that reproduces each presence sample (u < p)."""
    return np.where(presence > 0, prob * 0.5, (prob + 1.0) * 0.5)


@pytest.fixture(scope="module")
def cores():
    jts, jdec, seq = build_pair()
    rs = np.random.default_rng(3)
    img = rs.uniform(size=(B, H, H)).astype(np.float32)
    params = JSequentialAIR(jts, jdec).init(jax.random.PRNGKey(0), jnp.zeros((1, B, H, H)))
    load_flax_params(seq, to_numpy(params))
    p = params["timestep"]
    ts = seq.timestep
    out = {}

    # discovery: the S slots of one frame
    cond = (rs.standard_normal((B, NH)) * 0.3).astype(np.float32)
    jh, _ = jts.apply(p, jax.random.PRNGKey(7), img, cond,
                      method=lambda m, r, i, c: m.discover._discover(r, i, c))
    jh = to_numpy(jh)
    table = {}
    for k in range(S):
        table[(k, "where")] = (jh["where"][:, k] - jh["where_loc"][:, k]) / jh["where_scale"][:, k]
        table[(k, "what")] = (jh["what"][:, k] - jh["what_loc"][:, k]) / jh["what_scale"][:, k]
        table[(k, "presence")] = _uniform_from(jh["presence"][:, k], jh["presence_prob"][:, k])
    with torch.no_grad():
        th, _ = ts.discover._discover(torch.from_numpy(img), torch.from_numpy(cond),
                                      ReplayNoise(table, "cpu"))
    out["discovery"] = (jh, th)

    # propagation: S existing objects through one frame
    z = ((rs.standard_normal((B, S, NWHAT)) * 0.5).astype(np.float32),
         (rs.standard_normal((B, S, 4)) * 0.5).astype(np.float32),
         (rs.uniform(size=(B, S, 1)) < 0.7).astype(np.float32),
         np.zeros((B, S, 1), np.float32))
    temporal = (rs.standard_normal((B, S, NH)) * 0.3).astype(np.float32)
    jh, _, _, _, jt = jts.apply(
        p, jax.random.PRNGKey(11), img, z, (temporal,),
        method=lambda m, r, i, z_, t_: m.propagate._ssm(r, i, z_, t_))
    jh = to_numpy(jh)
    chol = np.asarray(p["params"]["propagate"]["ssm_cell"]["_where_distrib"]["cholesky_scale"])
    # the posterior's scale is diag(where_scale) (tril + I)
    tril_eye = np.eye(4)
    tril_eye[np.tril_indices(4)] += chol[:, 0]
    table = {}
    for k in range(S):
        y = (jh["where"][:, k] - jh["where_loc"][:, k]) / jh["where_scale"][:, k]
        table[(k, "where")] = np.linalg.solve(tril_eye[None].astype(np.float64),
                                              y[..., None].astype(np.float64))[..., 0]
        table[(k, "what")] = (jh["what"][:, k] - jh["what_loc"][:, k]) / jh["what_scale"][:, k]
        table[(k, "presence")] = _uniform_from(jh["presence"][:, k] * z[2][:, k],
                                               jh["presence_prob"][:, k])
    with torch.no_grad():
        th, _, _, _, tt = ts.propagate._ssm(
            torch.from_numpy(img), tuple(map(torch.from_numpy, z)),
            (torch.from_numpy(temporal),), ReplayNoise(table, "cpu"))
    th = dict(th, temporal_state=tt[0])
    jh = dict(jh, temporal_state=np.asarray(jt[0]))
    out["propagation"] = (jh, th)
    return out


@pytest.mark.parametrize("field", HIDDEN_OUTPUT_FIELDS)
@pytest.mark.parametrize("core", ("discovery", "propagation"))
def test_core_output_matches_jax(cores, core, field):
    want, got = cores[core]
    assert_close(got[field].numpy(), want[field], TOL, f"{core} {field}")


def test_propagation_temporal_state_matches_jax(cores):
    want, got = cores["propagation"]
    assert_close(got["temporal_state"].numpy(), want["temporal_state"], TOL, "temporal state")
