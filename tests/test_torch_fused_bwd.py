"""The backward halves of sqair_tpu_torch.ops.fused held to the JAX package.

- The plain backward versions (``mlp_bwd_plain``, ``vanilla_rnn_bwd_plain``,
  ``gru_bwd_plain``) against ``jax.vjp`` of the JAX package's CPU paths
  (the jnp references), and ``mlp_bwd_plain`` against the Pallas
  ``_pallas_backward`` in interpret mode at a tiny size.
- The ``torch.autograd.Function`` of each wrapper: ``gradcheck`` in float64
  on the CPU path (the saved tensors, the gradient order, ``None`` for the
  transfers), then its f32 gradient against ``jax.vjp``.

Tolerance 1e-5 on |a - b| / (max|b| + 1) per gradient: the same f32 products
summed in another order, over at most 400 terms of size ~1.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.ops import fused as jfused
from sqair_tpu_torch.ops import fused

TOL = 1e-5


def _rand(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _weights(rs, d_in, d_out):
    return _rand(rs, d_in, d_out, scale=d_in**-0.5), _rand(rs, d_out, scale=0.1)


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1.0)
    assert err <= TOL, f"{what}: scaled error {err:.3g} > {TOL}"


def _mlp_case(rs, d_in, n_layers, act, n=19):
    widths = [33, 17, 9][:n_layers]
    dims = [d_in] + widths
    params = [_weights(rs, a, b) for a, b in zip(dims[:-1], dims[1:])]
    transfers = ["elu"] * (n_layers - 1) + [act]
    x = rs.uniform(size=(n, d_in)).astype(np.float32)
    g = _rand(rs, n, widths[-1])
    return x, params, transfers, g


def _jax_mlp_vjp(x, params, transfers, g):
    jp = [tuple(map(jnp.asarray, p)) for p in params]
    _, vjp = jax.vjp(lambda x_, p_: jfused.mlp_reference(x_, p_, transfers), jnp.asarray(x), jp)
    dx, dp = vjp(jnp.asarray(g))
    return dx, dp


@pytest.mark.parametrize("d_in", (7, 400))
@pytest.mark.parametrize("n_layers", (1, 2, 3))
@pytest.mark.parametrize("act", fused.ACTS)
def test_mlp_bwd_plain_matches_jax_vjp(act, n_layers, d_in):
    rs = np.random.default_rng(d_in * 10 + n_layers)
    x, params, transfers, g = _mlp_case(rs, d_in, n_layers, act)
    tp = [tuple(map(torch.from_numpy, p)) for p in params]
    acts = fused.mlp_plain_acts(torch.from_numpy(x), tp, transfers)
    dx, dparams = fused.mlp_bwd_plain(torch.from_numpy(x), tp, transfers, acts,
                                      torch.from_numpy(g))
    want_dx, want_dp = _jax_mlp_vjp(x, params, transfers, g)
    _close(dx.numpy(), want_dx, "dx")
    for i, ((dw, db), (wdw, wdb)) in enumerate(zip(dparams, want_dp)):
        _close(dw.numpy(), wdw, f"dW_{i}")
        _close(db.numpy(), wdb, f"db_{i}")


def _cell_args(rs, cell, d_in, units=24, n=21):
    x = rs.uniform(size=(n, d_in)).astype(np.float32)
    h = rs.uniform(-1, 1, size=(n, units)).astype(np.float32)
    if cell == "vanilla_rnn":
        w, b = _weights(rs, d_in, units)
        return x, h, w, _weights(rs, units, units)[0], b
    wg, bg = _weights(rs, d_in, 2 * units)
    wc, bc = _weights(rs, d_in, units)
    return (x, h, wg, _weights(rs, units, 2 * units)[0], bg, wc,
            _weights(rs, units, units)[0], bc)


@pytest.mark.parametrize("d_in", (7, 400))
@pytest.mark.parametrize("cell", ("vanilla_rnn", "gru"))
def test_cell_bwd_plain_matches_jax_vjp(cell, d_in):
    rs = np.random.default_rng(d_in + 3)
    args = _cell_args(rs, cell, d_in)
    g = _rand(rs, *args[1].shape)
    t = [torch.from_numpy(a) for a in args]
    if cell == "vanilla_rnn":
        hn = fused.vanilla_rnn_plain(*t)
        got = fused.vanilla_rnn_bwd_plain(*t[:4], hn, torch.from_numpy(g))
        fn = jfused.fused_vanilla_rnn
        names = ("dx", "dh", "dW", "dU", "db")
    else:
        _, zr, c = fused.gru_plain_saving(*t)
        x, h, wg, ug, _, wc, uc, _ = t
        got = fused.gru_bwd_plain(x, h, wg, ug, wc, uc, zr, c, torch.from_numpy(g))
        fn = jfused.fused_gru
        names = ("dx", "dh", "dWg", "dUg", "dbg", "dWc", "dUc", "dbc")
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    # jax.vjp returns the gradients in argument order, which is the plain
    # versions' order
    for name, a, b in zip(names, got, vjp(jnp.asarray(g))):
        _close(a.numpy(), b, f"{cell} {name}")


def test_mlp_bwd_plain_matches_the_pallas_backward_interpreted(monkeypatch):
    """One tiny case of the TPU kernel itself, ``_pallas_backward``, run in
    interpret mode."""
    from jax.experimental import pallas

    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))
    rs = np.random.default_rng(11)
    x, params, transfers, g = _mlp_case(rs, 7, 3, "sigmoid", n=8)
    jp = tuple(tuple(map(jnp.asarray, p)) for p in params)
    acts = jfused._pallas_forward(jnp.asarray(x), jp, transfers)
    want_dx, want_dp = jfused._pallas_backward(jnp.asarray(x), jp, transfers, acts,
                                               jnp.asarray(g))
    tp = [tuple(map(torch.from_numpy, p)) for p in params]
    dx, dparams = fused.mlp_bwd_plain(torch.from_numpy(x), tp, transfers,
                                      [torch.from_numpy(np.array(a)) for a in acts],
                                      torch.from_numpy(g))
    _close(dx.numpy(), want_dx, "dx")
    for (dw, db), (wdw, wdb) in zip(dparams, want_dp):
        _close(dw.numpy(), wdw, "dW")
        _close(db.numpy(), wdb, "db")


def test_elu_derivative_at_zero_follows_the_tpu_kernel():
    """At a pre-activation of exactly 0 the port's elu derivative is 1, as
    the JAX package's TPU backward (``_act_grad_from_output``: a + 1) gives;
    ``jax.grad`` of the jnp reference gives 0.5 there (the tie of
    ``jnp.minimum``).  Zero-initialised biases and initial states make such
    ties common at initialisation, so the gradient tests of the whole model
    hold the port to the TPU kernels run in interpret mode."""
    a = torch.zeros(1, 1)
    assert float(fused.act_grad_from_output(a, "elu")) == 1.0
    assert float(jfused._act_grad_from_output(jnp.zeros(()), "elu")) == 1.0
    assert float(jax.grad(lambda z: jfused._apply_act(z, "elu"))(0.0)) == 0.5


def test_functions_pass_gradcheck_on_the_cpu():
    rs = np.random.default_rng(2)

    def t64(a):
        return torch.from_numpy(np.asarray(a, np.float64)).requires_grad_()

    x, params, transfers, _ = _mlp_case(rs, 5, 3, "tanh", n=4)
    xs = [t64(x)] + [t64(a) for p in params for a in p]
    assert torch.autograd.gradcheck(
        lambda x_, *fl: fused.fused_mlp(x_, list(zip(fl[0::2], fl[1::2])), transfers), xs)
    for cell, fn in (("vanilla_rnn", fused.fused_vanilla_rnn), ("gru", fused.fused_gru)):
        args = [t64(a) for a in _cell_args(rs, cell, 5, units=3, n=4)]
        assert torch.autograd.gradcheck(fn, args), cell


def test_function_gradients_match_jax_vjp():
    """The f32 gradient of each wrapper (its Function's CPU path) against
    jax.vjp of the JAX package's function."""
    rs = np.random.default_rng(4)
    x, params, transfers, g = _mlp_case(rs, 40, 2, "sigmoid")
    xs = [torch.from_numpy(x).requires_grad_()]
    ps = [tuple(torch.from_numpy(a).requires_grad_() for a in p) for p in params]
    y = fused.fused_mlp(xs[0], ps, transfers)
    leaves = xs + [a for p in ps for a in p]
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    want_dx, want_dp = _jax_mlp_vjp(x, params, transfers, g)
    for a, b in zip(got, [want_dx] + [t for p in want_dp for t in p]):
        _close(a.numpy(), b, "fused_mlp")
    for cell, fn, jfn in (("vanilla_rnn", fused.fused_vanilla_rnn, jfused.fused_vanilla_rnn),
                          ("gru", fused.fused_gru, jfused.fused_gru)):
        args = _cell_args(rs, cell, 40)
        gh = _rand(rs, *args[1].shape)
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        got = torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(gh))
        _, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
        for a, b in zip(got, vjp(jnp.asarray(gh))):
            _close(a.numpy(), b, cell)


def test_wrappers_call_the_c_prototypes(monkeypatch):
    """Every kernel call passes as many arguments as ops/build.py's
    PROTOTYPES declare, each one convertible to its declared C type (the
    library is a stand-in that only checks; CPU tensors pose as the card's)."""
    import ctypes

    from sqair_tpu_torch.ops import build

    calls = []

    class FakeLibrary:
        def __getattr__(self, name):
            argtypes = build.PROTOTYPES[name]

            def call(*args):
                assert len(args) == len(argtypes), (name, len(args), len(argtypes))
                for a, t in zip(args, argtypes):
                    t.from_param(a)
                calls.append(name)
                if name == "sqair_fused_mlp_bwd":  # the launch geometry, before the stream
                    seen_geom.append(args[-2])
                return 0
            return call

    seen_geom = []
    monkeypatch.setattr(build, "library", lambda: FakeLibrary())
    monkeypatch.setattr(fused, "_on_cuda", lambda name, x: True)
    monkeypatch.setattr(fused, "_stream", lambda device: ctypes.c_void_p(0))
    rs = np.random.default_rng(9)
    x, params, transfers, g = _mlp_case(rs, 7, 3, "tanh", n=5)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    tp = [tuple(map(torch.from_numpy, p)) for p in params]
    acts = fused._mlp_fwd_cuda(tx, tp, transfers, save=True)
    assert [a.shape[1] for a in acts] == [33, 17, 9]
    fused.fused_mlp_bwd(tx, tp, transfers, acts, tg, need_dx=False)
    args = [torch.from_numpy(a) for a in _cell_args(rs, "vanilla_rnn", 7, units=4, n=5)]
    hn = fused._vrnn_fwd_cuda(*args)
    fused.fused_vanilla_rnn_bwd(*args[:4], hn, hn)
    args = [torch.from_numpy(a) for a in _cell_args(rs, "gru", 7, units=4, n=5)]
    hn, zr, c = fused._gru_fwd_cuda(*args, save=True)
    x_, h_, wg, ug, _, wc, uc, _ = args
    fused.fused_gru_bwd(x_, h_, wg, ug, wc, uc, zr, c, hn)
    geom = fused.mlp_bwd_geometry(5, [7, 33, 17, 9])
    assert list(seen_geom[0]) == [geom[k] for k in ("tile_rows", "cluster", "blocks", "smem")]
    assert calls == ["sqair_fused_mlp", "sqair_fused_mlp_bwd", "sqair_fused_vanilla_rnn",
                     "sqair_fused_vanilla_rnn_bwd", "sqair_fused_gru", "sqair_fused_gru_bwd"]
    assert all(fused.launches[n] >= 1 for n in ("fused_mlp_bwd", "fused_vanilla_rnn_bwd",
                                                "fused_gru_bwd"))
