"""sqair_tpu_torch.ops held to sqair_tpu.ops on small shapes.

Tolerance 1e-5 on |a - b| / (|b| + 1): both sides evaluate the same f32
formulas; their transcendental functions and summation orders differ in
the last bits.  Orders and ids are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.ops import distributions as JD
from sqair_tpu.ops import indexing as jindexing
from sqair_tpu.ops import math as jmath
from sqair_tpu.ops import stn as jstn
from sqair_tpu.ops import targets as jtargets
from sqair_tpu_torch.ops import distributions as D
from sqair_tpu_torch.ops import indexing, stn, targets
from sqair_tpu_torch.ops import math as ops_math
from torch_parity import assert_close

RS = np.random.default_rng(0)


def _n(*shape, scale=1.0):
    return (RS.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def case_normal():
    loc, scale, x = _n(6, 3), np.exp(_n(6, 3, scale=0.5)), _n(6, 3)
    return [(JD.Normal(loc, scale).log_prob(x), D.Normal(_t(loc), _t(scale)).log_prob(_t(x)))]


def case_bernoulli():
    logits, x = _n(8, 3, scale=5.0), (RS.uniform(size=(8, 3)) < 0.5).astype(np.float32)
    j, t = JD.Bernoulli(logits=logits), D.Bernoulli(logits=_t(logits))
    u = RS.uniform(size=(8, 3)).astype(np.float32)
    return [(j.log_prob(x), t.log_prob(_t(x))), (j.probs, t.probs),
            ((u < jax.nn.sigmoid(logits)).astype(np.float32), t.sample(_t(u)))]


def case_geometric_and_categorical():
    k = RS.integers(0, 4, size=(7,)).astype(np.float32)
    logits = _n(7, 4)
    return [(JD.Geometric(probs=jnp.asarray(0.25)).log_prob(k),
             D.Geometric(probs=torch.tensor(0.25)).log_prob(_t(k))),
            (JD.Categorical(logits=logits).log_prob(k),
             D.Categorical(logits=_t(logits)).log_prob(_t(k)))]


def case_mvn_tril():
    chol = _n(10)
    tril = np.asarray(JD.fill_triangular(chol, 4))
    scale = np.exp(_n(5, 4, scale=0.3))
    batch = tril * scale[..., :, None] + np.einsum("...i,ij->...ij", scale, np.eye(4))
    loc, eps = _n(5, 4), _n(5, 4)
    j = JD.MultivariateNormalTriL(loc, batch.astype(np.float32))
    t = D.MultivariateNormalTriL(_t(loc), _t(batch.astype(np.float32)))
    x = loc + np.einsum("...ij,...j->...i", batch, eps)
    return [(tril, D.fill_triangular(_t(chol), 4)),
            (x, t.sample(_t(eps))),
            (j.log_prob(x.astype(np.float32)), t.log_prob(_t(x.astype(np.float32))))]


def case_num_steps():
    logits = _n(6, 3, scale=4.0)
    logits[0, 1:] = -88.0  # dead slots, as the -88 lock makes them
    n = RS.integers(0, 4, size=(6,)).astype(np.float32)
    j, t = JD.NumStepsDistribution(logits=logits), D.NumStepsDistribution(logits=_t(logits))
    return [(j.probs, t.probs), (j.log_prob(n), t.log_prob(_t(n)))]


def case_stn_coords():
    logits = _n(5, 4)
    coords = np.asarray(jstn.to_coords(logits))
    return [(coords, stn.to_coords(_t(logits))),
            (jstn.to_logits(coords), stn.to_logits(_t(coords)))]


def case_stn_crop_and_paste():
    img = RS.uniform(size=(3, 24, 20)).astype(np.float32)
    coords = np.asarray(jstn.to_coords(_n(3, 2, 4)))
    glimpse = RS.uniform(size=(3, 2, 8, 6)).astype(np.float32)
    uy, ux = jstn.paste_matrices(coords, (8, 6), (24, 20))
    tuy, tux = stn.paste_matrices(_t(coords), (8, 6), (24, 20))
    return [(jstn.extract_glimpse(img[:, None], coords, (8, 6)),
             stn.extract_glimpse(_t(img)[:, None], _t(coords), (8, 6))),
            (jstn.paste_glimpse(glimpse, coords, (24, 20)),
             stn.paste_glimpse(_t(glimpse), _t(coords), (24, 20))),
            (uy, tuy), (ux, tux)]


def case_presence_sort():
    # ties everywhere: several present and absent slots per row
    pres = (RS.uniform(size=(9, 6)) < 0.5).astype(np.float32)
    x = _n(9, 6, 5)
    ids = _n(9, 6, 1)
    jsel = jindexing.select_present({"x": x, "ids": ids}, pres, top_k=4)
    tsel = indexing.select_present({"x": _t(x), "ids": _t(ids)}, _t(pres), top_k=4)
    return [(jindexing.presence_sort_matrix(pres), indexing.presence_sort_matrix(_t(pres))),
            (jindexing.presence_sort_matrix(pres, 3),
             indexing.presence_sort_matrix(_t(pres), 3)),
            (jsel["x"], tsel["x"]), (jsel["ids"], tsel["ids"])]


def case_object_ids_and_tiling():
    last = np.array([[3.0], [-1.0], [0.0]], np.float32)
    prev = RS.integers(-1, 4, size=(3, 2, 1)).astype(np.float32)
    prop = (RS.uniform(size=(3, 2, 1)) < 0.5).astype(np.float32)
    disc = (RS.uniform(size=(3, 2, 1)) < 0.5).astype(np.float32)
    jl, jids = jindexing.compute_object_ids(last, prev, prop, disc)
    tl, tids = indexing.compute_object_ids(*map(_t, (last, prev, prop, disc)))
    obs = _n(2, 3, 4)
    return [(jl, tl), (jids, tids),
            (jindexing.tile_input_for_iwae(obs, 3, with_time=True),
             indexing.tile_input_for_iwae(_t(obs), 3, with_time=True))]


def case_targets():
    lw = _n(4, 5, scale=30.0)
    lp = _n(4, 5)
    w = np.asarray(jax.nn.softmax(lw, -1))
    return [(jtargets.iwae(lw), targets.iwae(_t(lw))),
            (jtargets.vimco_control_variate(lw), targets.vimco_control_variate(_t(lw))),
            (jtargets.vimco(lw, lp), targets.vimco(_t(lw), _t(lp))),
            (jtargets.reinforce(lw, lp), targets.reinforce(_t(lw), _t(lp))),
            (jmath.ess(w, average=True), ops_math.ess(_t(w), average=True))]


def case_clip_preserve():
    x = _n(6) * 3
    jgrad = jax.grad(lambda v: jnp.sum(jmath.clip_preserve(v, -1.0, 1.0) ** 2))(x)
    tx = _t(x).requires_grad_()
    out = ops_math.clip_preserve(tx, -1.0, 1.0)
    (out**2).sum().backward()
    return [(jmath.clip_preserve(x, -1.0, 1.0), out.detach()), (jgrad, tx.grad)]


CASES = {name[5:]: fn for name, fn in list(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    for i, (want, got) in enumerate(CASES[name]()):
        assert_close(got.detach().numpy(), np.asarray(want), 1e-5, f"{name}[{i}]")
