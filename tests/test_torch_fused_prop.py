"""The fused propagation unroll's plain versions (sqair_tpu_torch/ops/
fused_cells.py) held to the JAX package's: ``prop_ssm_ref`` and jax.grad of
it at the sizes of tests/test_fused_cells.py, and JAX's own
``fused_prop_ssm`` (its Pallas kernels in interpret mode, whose backward
takes elu'(0) = 1 as the port does) at one case with exact zeros.  Inputs
from a numpy seed, the noise passed in.

Tolerances: forward |d| <= 1e-5 + 1e-4 |value| on every output (and every
residual field against JAX's kernel); gradients 1e-4 of each gradient's
largest |entry| (+1e-7).
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

B, S, HH, GG, NW, U, SP, WB, MH = 4, 3, 16, 6, 5, 16, 8, 12, 10
FIELDS = fused_cells.OUT_FIELDS + ("what_sample", "where_sample")
ATOL, RTOL, GRAD_TOL = 1e-5, 1e-4, 1e-4


def _case(seed, zero_biases=False):
    """(img, z3, th, h0, eps_w, eps_x, u, params) as numpy arrays, the params
    as a tuple tree in the order of PropParams."""
    rs = np.random.RandomState(seed)

    def w(m, n, s=0.4):
        return (rs.randn(m, n) * s / np.sqrt(m)).astype(np.float32)

    def b(n, v=0.0):
        out = np.full((n,), v, np.float32)
        return out if zero_biases else out + (rs.randn(n) * 0.01).astype(np.float32)

    img = rs.rand(B, HH, HH).astype(np.float32)
    z3 = ((rs.randn(S, B, NW) * 0.5).astype(np.float32),
          (rs.randn(S, B, 4) * 0.5).astype(np.float32),
          (rs.rand(S, B, 1) < 0.7).astype(np.float32))
    th = (rs.randn(S, B, U) * 0.3).astype(np.float32)
    if zero_biases:  # a slot's temporal state at 0, as at initialisation
        th[0] = 0.0
    h0 = np.zeros((1, U), np.float32) if zero_biases else \
        (rs.randn(1, U) * 0.1).astype(np.float32)
    eps_w = rs.randn(S, B, 4).astype(np.float32)
    eps_x = rs.randn(S, B, NW).astype(np.float32)
    u = rs.rand(S, B, 1).astype(np.float32)
    G, d_tin = GG * GG, U + 4 + 2 * NW
    p = (((w(U, WB), b(WB)), (w(WB, 4), b(4))),
         ((w(U, MH), b(MH)), (w(MH, G), b(G, 1.0))),
         ((w(G, U), b(U)), (w(U, U), b(U))),
         (w(U, 2 * NW), b(2 * NW)),
         (w(3 * NW + 10 + U, U), w(U, U), b(U)),
         ((w(2 * U + 4, U), b(U)), (w(U, U), b(U)), (w(U, 8), b(8))),
         np.asarray(-1.5, np.float32),
         np.tril(rs.randn(4, 4) * 0.2).astype(np.float32),
         (w(d_tin, 2 * U), w(U, 2 * U), b(2 * U), w(d_tin, U), w(U, U), b(U)),
         (w(U, 2 * NW), b(2 * NW)),
         (w(U, 3 * NW), b(3 * NW, 1.0)),
         ((w(2 * U + NW, SP), b(SP)), (w(SP, 1), b(1, 5.0))))
    return img, z3, th, h0, eps_w, eps_x, u, p


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree, grad=False):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=grad), tree)


def _port(img, z3, th, h0, eps_w, eps_x, u, p):
    plogit = torch.zeros_like(z3[2])
    return fused_cells.fused_prop_ssm(img, tuple(z3) + (plogit,), th, h0, eps_w, eps_x, u,
                                      fused_cells.PropParams(*p), (GG, GG))


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


def _cotangents(shapes, seed):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _jax_run(fn, case, cots):
    """fn's outputs and jax.grad of sum(out * cot) over the outputs for z3,
    th, h0, params, from one jitted call."""
    img, z3, th, h0, eps_w, eps_x, u, p = _jax(case)

    def loss(z3, th, h0, p):
        out = fn(img, z3, th, h0, eps_w, eps_x, u, p)
        return sum(jnp.sum(out[k] * cots[k]) for k in cots), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                 has_aux=True))(z3, th, h0, p)
    return out, grads


def _port_grads(case, cots):
    img, z3, th, h0, eps_w, eps_x, u, p = case
    z3_t, th_t, h0_t, p_t = _torch((z3, th, h0, p), grad=True)
    out = _port(*_torch((img,)), z3_t, th_t, h0_t, *_torch((eps_w, eps_x, u)), p_t)
    sum(torch.sum(out[k] * torch.from_numpy(c)) for k, c in cots.items()).backward()
    return jax.tree_util.tree_map(lambda t: t.grad.numpy(), (z3_t, th_t, h0_t, p_t))


def _jp(p):
    return jfc.PropParams(*p)


def _ref(img, z3, th, h0, eps_w, eps_x, u, p):
    return jfc.prop_ssm_ref(img, tuple(z3) + (jnp.zeros_like(z3[2]),), th,
                            jnp.broadcast_to(h0, (B, U)), eps_w, eps_x, u, _jp(p), (GG, GG))


def _jax_fused(img, z3, th, h0, eps_w, eps_x, u, p):
    return jfc.fused_prop_ssm(img, tuple(z3) + (jnp.zeros_like(z3[2]),), th, h0, eps_w, eps_x,
                              u, _jp(p), (GG, GG))


def test_plain_forward_and_gradients_match_prop_ssm_ref():
    case = _case(1)
    with torch.no_grad():
        got = _port(*_torch(case))
    cots = _cotangents({k: tuple(got[k].shape) for k in FIELDS}, 8)
    want, gw = _jax_run(_ref, case, cots)
    assert float(jnp.sum(want["presence"])) > 0  # a case where objects live
    assert sorted(got) == sorted(want)
    for k in FIELDS:
        _close(got[k].numpy(), want[k], f"fwd {k}")

    gp = _port_grads(case, cots)
    flat_w, tree = jax.tree_util.tree_flatten_with_path(gw)
    flat_p = jax.tree_util.tree_leaves(gp)
    assert len(flat_w) == len(flat_p) == 3 + 2 + 38 + 1
    for (path, a), b in zip(flat_w, flat_p):
        _grad_close(b, a, f"grad {jax.tree_util.keystr(path)}")


def test_plain_versions_match_the_jax_kernels_in_interpret_mode():
    """Zero biases, h0 and one slot's temporal state put pre-activations at
    exactly 0, where the kernels' elu' is 1 (and the jnp reference's 0.5)."""
    case = _case(2, zero_biases=True)
    dims = (S, GG, GG, NW, U, SP, WB, MH)

    def jax_residual(img, z3, th, h0, eps_w, eps_x, u, p):
        """JAX's residual blob, read field by field through its own offsets."""
        jp = _jp(p)
        s3w, s3b = jp.stp[2]
        fold = jnp.concatenate([jnp.zeros(4), jnp.ones(4)]) * (jp.stp_offset - 1.0)
        (we1, be1), l2 = jp.ge_enc
        jp = jp._replace(stp=(jp.stp[0], jp.stp[1], (s3w, s3b + fold)),
                         ge_enc=((we1.reshape((GG, GG, U)), be1), l2))
        return jfc._prop_run_fwd(img, z3, th, jnp.broadcast_to(h0, (B, U)),
                                 (eps_w, eps_x, u), jfc._prop_weights_flat(jp), dims)[10]

    with torch.no_grad():
        got = _port(*_torch(case))
        args = _torch(case)
        pt = fused_cells.PropParams(*args[7])
        s3w_t, s3b_t = pt.stp[2]
        pt = pt._replace(stp=(pt.stp[0], pt.stp[1], (s3w_t, s3b_t + torch.cat(
            [torch.zeros(4), torch.ones(4)]) * (pt.stp_offset - 1.0))))
        res = fused_cells.prop_plain_fwd(args[0], *args[1], args[2], args[3].expand(B, U),
                                         *args[4:7], fused_cells.weights_flat(pt), dims)[10]
    cots = _cotangents({k: tuple(got[k].shape) for k in FIELDS}, 9)
    with tpu_kernels_interpreted():
        want, gw = _jax_run(_jax_fused, case, cots)
        jres = jax.jit(jax_residual)(*_jax(case))
    assert sorted(got) == sorted(want)
    for k in FIELDS:
        _close(got[k].numpy(), want[k], f"fwd {k}")
    offs, _ = fused_cells.residual_layout(dims)
    joffs, _ = jfc._prop_offsets(U, SP, NW, WB, MH, GG * GG)
    for name, (a, b) in offs.items():
        ja = joffs[name][0]
        _close(res[..., a:b].numpy(), np.asarray(jres[..., ja:ja + b - a]), f"residual {name}")
    gp = _port_grads(case, cots)
    flat_w = jax.tree_util.tree_flatten_with_path(gw)[0]
    for (path, a), b in zip(flat_w, jax.tree_util.tree_leaves(gp)):
        _grad_close(b, a, f"grad {jax.tree_util.keystr(path)}")


def test_the_cuda_request_raises_without_a_card(monkeypatch):
    """A tensor on the card goes to the kernel, never to the plain version:
    without a card the kernel library raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(fused_cells, "_on_cuda", lambda name, x: True)
    with pytest.raises(RuntimeError, match="need a CUDA device"), torch.no_grad():
        _port(*_torch(_case(1)))
