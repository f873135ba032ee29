"""The fused discovery unroll's plain versions (sqair_tpu_torch/ops/
fused_cells.py) held to the JAX package's: ``disc_ssm_ref`` for the
forward, and JAX's own ``fused_disc_ssm`` (its Pallas kernels in interpret
mode, whose backward takes elu'(0) = 1 as the port does) for the forward,
every residual field and the gradients, at one random case and one with
zero biases and zero h0 (exact zeros).  Inputs from a numpy seed, the noise
passed in.  JAX's interpret-mode kernels are compiled once for the module
and run for both cases.

Tolerances: forward |d| <= 1e-5 + 1e-4 |value| on every output and every
residual field; gradients 1e-4 of each gradient's largest |entry| (+1e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqair_tpu.ops.fused_cells as jfc
from sqair_tpu_torch.ops import fused_cells
from torch_parity import tpu_kernels_interpreted
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

B, S, HH, GG, NW, U, SP, C = 4, 3, 16, 6, 5, 16, 8, 12
DIMS = (S, GG, GG, NW, U, SP)
FIELDS = fused_cells.DISC_OUT_FIELDS
ATOL, RTOL, GRAD_TOL = 1e-5, 1e-4, 1e-4


def _case(seed, zero_biases=False):
    """(img, cond, h0, eps_w, eps_x, u, params) as numpy arrays, the params
    as a tuple tree in the order of DiscParams."""
    rs = np.random.RandomState(seed)

    def w(m, n, s=0.6):
        return (rs.randn(m, n) * s / np.sqrt(m)).astype(np.float32)

    def b(n, v=0.0):
        out = np.full((n,), v, np.float32)
        return out if zero_biases else out + (rs.randn(n) * 0.01).astype(np.float32)

    img = rs.rand(B, HH, HH).astype(np.float32)
    if zero_biases:  # a blank frame: both encoders' pre-activations at 0
        img[0] = 0.0
    cond = (rs.randn(B, C) * 0.5).astype(np.float32)
    h0 = np.zeros((1, U), np.float32) if zero_biases else \
        (rs.randn(1, U) * 0.1).astype(np.float32)
    eps_w = rs.randn(S, B, 4).astype(np.float32)
    eps_x = rs.randn(S, B, NW).astype(np.float32)
    u = rs.rand(S, B, 1).astype(np.float32)
    p = (((w(HH * HH, U), b(U)), (w(U, U), b(U))),
         (w(U + C + NW + 5, U), w(U, U), b(U)),
         ((w(U, U), b(U)), (w(U, U), b(U)), (w(U, 8), b(8))),
         np.asarray(-1.5, np.float32),
         ((w(GG * GG, U), b(U)), (w(U, U), b(U))),
         (w(U, 2 * NW), b(2 * NW)),
         ((w(U + NW, SP), b(SP)), (w(SP, 1), b(1, 1.0))))
    return img, cond, h0, eps_w, eps_x, u, p


CASES = {"random": _case(1), "zero_biases": _case(2, zero_biases=True)}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=grad), tree)


def _port(img, cond, h0, eps_w, eps_x, u, p):
    return fused_cells.fused_disc_ssm(img, img.reshape(B, -1), cond, h0, eps_w, eps_x, u,
                                      fused_cells.DiscParams(*p), (GG, GG))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got - want)
    assert np.all(d <= ATOL + RTOL * np.abs(want)), f"{what}: max |d| {d.max():.3g}"


def _grad_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    tol = GRAD_TOL * float(np.max(np.abs(want))) + 1e-7
    assert err <= tol, f"{what}: {err:.3g} > {tol:.3g}"


def _cotangents(seed):
    rs = np.random.RandomState(seed)
    widths = (NW, NW, NW, 4, 4, 4, 1, 1, 1)
    return {k: rs.randn(S, B, d).astype(np.float32) for k, d in zip(FIELDS, widths)}


def _kernel_args(img, cond, h0, p):
    """The JAX kernels' arguments as ``fused_disc_ssm`` prepares them: the
    scale offset folded, We1 reshaped [gh, gw, U], h0 broadcast."""
    jp = jfc.DiscParams(*p)
    s3w, s3b = jp.stp[2]
    fold = jnp.concatenate([jnp.zeros(4), jnp.ones(4)]) * jp.stp_offset
    (we1, be1), l2 = jp.ge_enc
    jp = jp._replace(stp=(jp.stp[0], jp.stp[1], (s3w, s3b + fold)),
                     ge_enc=((we1.reshape((GG, GG, U)), be1), l2))
    return img, img.reshape(B, -1), cond, jnp.broadcast_to(h0, (B, U)), jfc._disc_weights_flat(jp)


@jax.jit
def _jax_kernels(img, cond, h0, eps_w, eps_x, u, p, cots):
    """JAX's fused path: its forward kernel's outputs and residuals
    (``_disc_run_fwd``), and the gradients of sum(out * cot) through
    ``fused_disc_ssm`` (its custom VJP, the backward kernel) for cond, h0 and
    the params."""
    img_, imgf, cond_, h0b, weights = _kernel_args(img, cond, h0, p)
    run = jfc._disc_run_fwd(img_, imgf, cond_, h0b, eps_w, eps_x, u, weights, DIMS)

    def loss(cond, h0, p):
        out = jfc.fused_disc_ssm(img, img.reshape(B, -1), cond, h0, eps_w, eps_x, u,
                                 jfc.DiscParams(*p), (GG, GG))
        return sum(jnp.sum(out[k] * cots[k]) for k in cots)

    grads = jax.grad(loss, argnums=(0, 1, 2))(cond, h0, p)
    return dict(zip(FIELDS, run[:9])), run[9], run[10], run[11], grads


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's kernel results for every case, from one compile."""
    with tpu_kernels_interpreted():
        return {name: _jax_kernels(*_jax(case), _jax(_cotangents(7)))
                for name, case in CASES.items()}


def test_plain_forward_matches_disc_ssm_ref():
    img, cond, h0, eps_w, eps_x, u, p = case = CASES["random"]
    with torch.no_grad():
        got = _port(*_torch(case))
    ji = _jax(case)
    want = jax.jit(lambda img, cond, h0, eps_w, eps_x, u, p: jfc.disc_ssm_ref(
        img, img.reshape(B, -1), cond, jnp.broadcast_to(h0, (B, U)), eps_w, eps_x, u,
        jfc.DiscParams(*p), (GG, GG)))(*ji)
    assert 0 < float(jnp.sum(want["presence"])) < S * B  # objects live and die
    assert sorted(got) == sorted(want)
    for k in FIELDS:
        _close(got[k].numpy(), want[k], f"fwd {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_versions_match_the_jax_kernels_in_interpret_mode(case, jax_runs):
    """Every output and residual field, and the gradients of cond, h0 and
    all 23 weights and the scale offset (through the fold).  The zero-bias
    case puts pre-activations at exactly 0, where the kernels' elu' is 1
    (and the jnp reference's 0.5)."""
    img, cond, h0, eps_w, eps_x, u, p = CASES[case]
    want, jres, jg0s, jfres, jgrads = jax_runs[case]
    args = _torch(CASES[case])
    with torch.no_grad():
        got = _port(*args)
        pt = fused_cells.DiscParams(*args[6])
        s3w, s3b = pt.stp[2]
        pt = pt._replace(stp=(pt.stp[0], pt.stp[1], (s3w, s3b + torch.cat(
            [torch.zeros(4), torch.ones(4)]) * pt.stp_offset)))
        run = fused_cells.disc_plain_fwd(args[0], args[0].reshape(B, -1), args[1],
                                         args[2].expand(B, U), *args[3:6],
                                         fused_cells.disc_weights_flat(pt), DIMS)
    for k in FIELDS:
        _close(got[k].numpy(), want[k], f"fwd {k}")
    res, g0s, fres = run[9:]
    offs, _ = fused_cells.disc_residual_layout(DIMS)
    joffs, _ = jfc._disc_offsets(U, SP, GG, GG)
    assert sorted(offs) == sorted(joffs)
    for name, (a, b) in offs.items():
        ja = joffs[name][0]
        _close(res[..., a:b].numpy(), np.asarray(jres[..., ja:ja + b - a]), f"residual {name}")
    _close(g0s.numpy(), np.asarray(jg0s).reshape(S, B, GG * GG), "glimpses")
    _close(fres.numpy(), jfres, "input encoder layers")

    cond_t, h0_t, p_t = _torch((cond, h0, p), grad=True)
    out = _port(args[0], cond_t, h0_t, *args[3:6], p_t)
    sum(torch.sum(out[k] * torch.from_numpy(c)) for k, c in _cotangents(7).items()).backward()
    gp = jax.tree_util.tree_map(lambda t: t.grad.numpy(), (cond_t, h0_t, p_t))
    flat_w = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat_p = jax.tree_util.tree_leaves(gp)
    assert len(flat_w) == len(flat_p) == 2 + 23 + 1
    for (path, a), b in zip(flat_w, flat_p):
        _grad_close(b, a, f"grad {jax.tree_util.keystr(path)}")


def test_the_cuda_request_raises_without_a_card(monkeypatch):
    """A tensor on the card goes to the kernel, never to the plain version:
    without a card the kernel library raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(fused_cells, "_on_cuda", lambda name, x: True)
    with pytest.raises(RuntimeError, match="need a CUDA device"), torch.no_grad():
        _port(*_torch(CASES["random"]))
