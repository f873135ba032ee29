"""The port's conv modules and LSTM (sqair_tpu_torch/nn/layers.py) held to
the JAX package's flax modules (sqair_tpu/nn/layers.py): the same inputs
and weights (drawn from a numpy seed, converted with convert.py), the
forward values and the gradients of the input and of every parameter
(``jax.grad`` of the same cotangent-weighted sum), at 1e-5 on
|a - b| / (|b| + 1).

The shapes catch what a shape test cannot: flax's SAME padding at stride 2
is asymmetric on an even side (26 -> 13 pads (0, 1)) and symmetric on an
odd one (13 -> 7 pads (1, 1)); ConvEncoder flattens NHWC as (h, w, c); the
depth-to-space reads its channels as (b1, b2, c).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.nn import layers as jlayers
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.nn import layers
from torch_parity import assert_close, to_numpy
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5


def _draw(tree, seed):
    """The flax tree with every leaf redrawn from a numpy seed (lecun-scaled
    normals: the biases too, so that a mis-wired bias shows)."""
    rs = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        scale = 1.0 / math.sqrt(max(1, int(np.prod(x.shape[:-1]))))
        return rs.standard_normal(x.shape).astype(np.float32) * scale

    return jax.tree_util.tree_map(leaf, to_numpy(tree))


def _check(jmodule, module, x, seed=0):
    """Forward values and input / parameter gradients of the port's module
    against the flax module's on the same weights and cotangent."""
    x = np.asarray(x, np.float32)
    params = _draw(jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    load_flax_params(module, params)

    def jfn(p, xx):
        return jmodule.apply(p, xx)

    want = np.asarray(jax.jit(jfn)(params, jnp.asarray(x)))
    cot = np.random.default_rng(seed + 1).standard_normal(want.shape).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, xx: jnp.sum(jfn(p, xx) * cot), argnums=(0, 1)))(
        params, jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    got = module(xt)
    assert_close(got.detach().numpy(), want, TOL, "forward")
    torch.sum(got * torch.from_numpy(cot)).backward()
    assert_close(xt.grad.numpy(), np.asarray(jgx), TOL, "input gradient")
    want_grads = params_from_flax(to_numpy(jgp), module)
    for name, p in module.named_parameters():
        assert_close(p.grad.numpy(), want_grads[name].numpy(), TOL, f"d{name}")


@pytest.mark.parametrize("size, stride, rate", [
    (13, [1, 2, 1], [2, 1, 1]),  # a dilated layer, then an odd stride-2 input
    (12, 2, 1),                  # even sides at stride 2 throughout
])
def test_convnet_matches_flax(size, stride, rate):
    jm = jlayers.ConvNet(3, [4, 6], n_out=3, stride=stride, rate=rate)
    m = layers.ConvNet(2, 3, [4, 6], n_out=3, stride=stride, rate=rate)
    x = np.random.default_rng(2).uniform(size=(3, size, size + 1, 2))
    _check(jm, m, x)


@pytest.mark.parametrize("size", [26, 20])
def test_conv_encoder_matches_flax(size):
    """26x26: 26 -> 13 (pads (0, 1)) -> 7 (pads (1, 1)); 20x20: 20 -> 10 ->
    5, both (0, 1).  Inputs flattened [..., h w] with two leading axes."""
    jm = jlayers.ConvEncoder((size, size), [4, 8], n_features=16)
    m = layers.ConvEncoder((size, size), [4, 8], n_features=16)
    assert m.MLP_0.n_layers == 1 and m.d_out == 16
    x = np.random.default_rng(3).uniform(size=(2, 3, size * size))
    _check(jm, m, x, seed=1)


def test_same_padding_follows_flax():
    assert [layers.same_padding(s, 3, 2) for s in (50, 25, 20, 10, 26, 13)] == [
        (0, 1), (1, 1), (0, 1), (0, 1), (0, 1), (1, 1)]
    assert layers.same_padding(9, 3, 1, dilation=2) == (2, 2)


def test_depth_to_space_matches_reference_layout():
    """JAX's tests/test_nn.py case, and a random one against JAX's."""
    x = torch.arange(4.0).reshape(1, 1, 1, 4)
    y = layers._depth_to_space(x, 2)
    assert y[0, :, :, 0].tolist() == [[0.0, 1.0], [2.0, 3.0]]
    x = np.random.default_rng(4).standard_normal((2, 3, 4, 3 * 9)).astype(np.float32)
    want = np.asarray(jlayers.UpConvNet._depth_to_space(jnp.asarray(x), 3))
    np.testing.assert_array_equal(layers._depth_to_space(torch.from_numpy(x), 3).numpy(), want)


def test_upconvnet_matches_flax():
    jm = jlayers.UpConvNet(3, [5, 4], n_out=2, stride=[2, 3, 1])
    m = layers.UpConvNet(3, 3, [5, 4], n_out=2, stride=[2, 3, 1])
    x = np.random.default_rng(5).uniform(size=(2, 3, 4, 3))
    _check(jm, m, x, seed=2)


@pytest.mark.parametrize("glimpse", [10, 20])
def test_subpixel_decoder_matches_flax(glimpse):
    jm = jlayers.SubpixelDecoder([16, 16], (glimpse, glimpse), 0.25)
    m = layers.SubpixelDecoder(7, [16, 16], (glimpse, glimpse), 0.25)
    x = np.random.default_rng(6).standard_normal((2, 3, 7))
    _check(jm, m, x, seed=3)


def test_lstm_matches_flax():
    """Two steps from the trainable initial state, (c, h) carried."""
    units, d_in, B = 6, 5, 4
    jm = jlayers.LSTM(units)
    m = layers.make_cell("LSTM", d_in, units)
    xs = np.random.default_rng(7).standard_normal((2, B, d_in)).astype(np.float32)

    def jrun(p, x):
        def body(mdl, x):
            state = mdl.initial_state(B)
            outs = []
            for t in range(2):
                state, out = mdl(state, x[t])
                outs.append(out)
            return jnp.stack(outs + [state[0]], 0)
        return jm.apply(p, x, method=body)

    zeros = jnp.zeros((B, units))
    params = _draw(jm.init(jax.random.PRNGKey(0), (zeros, zeros), jnp.asarray(xs[0])), 4)
    assert sorted(params["params"]) == ["c0", "h0", "ifgo"]
    load_flax_params(m, params)

    def trun(x):
        state = m.initial_state(B)
        assert len(state) == 2 and layers.state_feature(state) is state[1]
        outs = []
        for t in range(2):
            state, out = m(state, x[t])
            outs.append(out)
        return torch.stack(outs + [state[0]], 0)

    want = np.asarray(jax.jit(jrun)(params, jnp.asarray(xs)))
    cot = np.random.default_rng(8).standard_normal(want.shape).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, x: jnp.sum(jrun(p, x) * cot), argnums=(0, 1)))(
        params, jnp.asarray(xs))
    xt = torch.tensor(xs, requires_grad=True)
    got = trun(xt)
    assert_close(got.detach().numpy(), want, TOL, "forward")
    torch.sum(got * torch.from_numpy(cot)).backward()
    assert_close(xt.grad.numpy(), np.asarray(jgx), TOL, "input gradient")
    want_grads = params_from_flax(to_numpy(jgp), m)
    for name, p in m.named_parameters():
        assert_close(p.grad.numpy(), want_grads[name].numpy(), TOL, f"d{name}")


def test_conv_kernel_draw_and_layout():
    """A conv kernel is drawn HWIO with flax's lecun_normal fan-in kh kw c_in
    (truncated at 2 std), and a flax kernel converts as it is."""
    conv = layers.Conv(8, 32, 3)
    layers.init_params(conv, torch.Generator().manual_seed(0))
    k = conv.kernel.detach()
    assert tuple(k.shape) == (3, 3, 8, 32)
    std = 1.0 / math.sqrt(3 * 3 * 8)
    assert float(k.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(k.std()) - std) < 0.1 * std
    jk = jlayers.ConvNet(3, [32]).init(jax.random.PRNGKey(1), jnp.zeros((1, 6, 6, 8)))
    jstd = float(np.std(np.asarray(jk["params"]["Conv_0"]["kernel"])))
    assert abs(jstd - std) < 0.1 * std
    dense = layers.Dense(40, 7)
    layers.init_params(dense, torch.Generator().manual_seed(0))
    assert abs(float(dense.kernel.detach().std()) - 1 / math.sqrt(40)) < 0.15 / math.sqrt(40)


def test_conv_model_turns_tf32_off_and_convolutions_deterministic():
    """Building a conv layer sets the cuDNN settings the conv path needs,
    whatever ran before (the settings are process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model

    conv_mnist_model.load(dict(mlp_mnist_model.DEFAULTS, n_units=1, conv_channels="2,2",
                               glimpse_size=10), (20, 20), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
