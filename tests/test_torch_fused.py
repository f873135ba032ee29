"""sqair_tpu_torch.ops.fused: the plain versions of the three kernels held
to the JAX package's CPU paths, and the wrappers' device rules.

Tolerance 1e-6 abs + 1e-6 rel: both sides compute the same f32 products,
summed in another order, over at most 2500 terms of size ~1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.ops import fused as jfused
from sqair_tpu_torch.ops import fused

TOL = dict(rtol=1e-6, atol=1e-6)
D_INS = (7, 400, 2500)


def _rand(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _weights(rs, d_in, d_out):
    return _rand(rs, d_in, d_out, scale=d_in**-0.5), _rand(rs, d_out, scale=0.1)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("d_in", D_INS)
@pytest.mark.parametrize("act", fused.ACTS)
def test_mlp_plain_matches_jax(act, d_in):
    rs = np.random.default_rng(d_in)
    x = rs.uniform(size=(33, d_in)).astype(np.float32)
    params = [_weights(rs, d_in, 64), _weights(rs, 64, 48)]
    transfers = ("elu", act)
    want = jfused.mlp_reference(jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in params],
                                transfers)
    got = fused.mlp_plain(torch.from_numpy(x), [tuple(_t(*p)) for p in params], transfers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d_in", D_INS)
@pytest.mark.parametrize("cell", ("vanilla_rnn", "gru"))
def test_cell_plain_matches_jax(cell, d_in):
    rs = np.random.default_rng(d_in + 1)
    units = 32
    x = rs.uniform(size=(21, d_in)).astype(np.float32)
    h = rs.uniform(-1, 1, size=(21, units)).astype(np.float32)
    if cell == "vanilla_rnn":
        w, b = _weights(rs, d_in, units)
        args = (x, h, w, _weights(rs, units, units)[0], b)
        want = jfused.fused_vanilla_rnn(*map(jnp.asarray, args))
        got = fused.vanilla_rnn_plain(*_t(*args))
    else:
        wg, bg = _weights(rs, d_in, 2 * units)
        wc, bc = _weights(rs, d_in, units)
        args = (x, h, wg, _weights(rs, units, 2 * units)[0], bg, wc,
                _weights(rs, units, units)[0], bc)
        want = jfused.fused_gru(*map(jnp.asarray, args))
        got = fused.gru_plain(*_t(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_versions():
    rs = np.random.default_rng(0)
    x = torch.from_numpy(rs.uniform(size=(5, 7)).astype(np.float32))
    params = [tuple(_t(*_weights(rs, 7, 9)))]
    h = torch.zeros(5, 9)
    w, b = _t(*_weights(rs, 7, 9))
    u = torch.from_numpy(_weights(rs, 9, 9)[0])
    fused.reset_launches()
    assert torch.equal(fused.fused_mlp(x, params, ["tanh"]),
                       fused.mlp_plain(x, params, ["tanh"]))
    assert torch.equal(fused.fused_vanilla_rnn(x, h, w, u, b),
                       fused.vanilla_rnn_plain(x, h, w, u, b))
    assert sum(fused.launches.values()) == 0
    with pytest.raises(ValueError, match="unknown transfer"):
        fused.fused_mlp(x, params, ["relu"])


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mlp_mnist_model.load({"n_units": 1, "n_what": 4}, (24, 24))
    assert resolve_device("cpu").type == "cpu"
