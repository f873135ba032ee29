"""The fused glimpse encoder (TPU kernels #11/#12): sqair_tpu_torch's plain
forward and backward held to the JAX package's ``_run_fwd`` / ``_run_bwd``
run in interpret mode, its autograd Function held to the port's unfused
AIREncoder, and the wrapper's CUDA request.

Sizes are small (B=6, 16x16 frames, 6x6 glimpses, 32 wide); inputs come
from numpy seeds.  Tolerance 1e-5 on |a - b| / (|b| + 1) for every output,
the saved tensors included, and for every gradient, the where-gradient
included: f32 on both sides, sums of at most 36 terms in another order.
Against the unfused encoder the gradients agree to 1e-5 of each tensor's
largest entry: the same chain computed by autograd instead of by hand
(random inputs keep off the kinks of the interpolation weights and off
exact elu zeros, where the two may differ).
"""
import contextlib
import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.ops import fused_glimpse as jglimpse
from sqair_tpu_torch.nn.layers import Encoder, init_params
from sqair_tpu_torch.models.air import AIREncoder
from sqair_tpu_torch.ops import build, fused, fused_glimpse
from torch_parity import assert_close
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

B, H, W, GH, GW, D_MI, D_M, D1, D2, N_WHAT = 6, 16, 16, 6, 6, 32, 32, 32, 32, 8
DIMS = (GH, GW, N_WHAT)
TOL = 1e-5


@contextlib.contextmanager
def _interpreted():
    from jax.experimental import pallas

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call", functools.partial(pallas.pallas_call, interpret=True))
        yield


def _case(masked, seed=0):
    """Numpy inputs of one call: img, wl, mi, mask_params, enc_params, head_w,
    head_b, and output gradients dloc, dscale."""
    rs = np.random.default_rng(seed)

    def w(a, b):
        return (rs.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)

    def b(n, loc=0.0):
        return (loc + 0.1 * rs.normal(size=n)).astype(np.float32)

    img = rs.uniform(size=(B, H, W)).astype(np.float32)
    wl = rs.normal(size=(B, 4)).astype(np.float32)
    mi = rs.normal(size=(B, D_MI)).astype(np.float32) if masked else None
    mask = ((w(D_MI, D_M), b(D_M)), (w(D_M, GH * GW), b(GH * GW, 1.0))) if masked else None
    enc = ((w(GH * GW, D1), b(D1)), (w(D1, D2), b(D2)))
    head_w, head_b = w(D2, 2 * N_WHAT), b(2 * N_WHAT)
    g = (rs.normal(size=(B, N_WHAT)).astype(np.float32),
         rs.normal(size=(B, N_WHAT)).astype(np.float32))
    return (img, wl, mi, mask, enc, head_w, head_b), g


def _tree(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_tree(fn, t) for t in tree)
    return fn(tree)


def _torch(tree):
    return _tree(torch.from_numpy, tree)


@pytest.mark.parametrize("masked", (True, False))
def test_plain_forward_matches_jax_run_fwd(masked):
    args, _ = _case(masked)
    with _interpreted():
        want = jglimpse._run_fwd(*_tree(jnp.asarray, args), DIMS)
    got = fused_glimpse.glimpse_plain_fwd(*_torch(args), DIMS)
    names = ["loc", "scale", "g0", "h1", "h2"] + (["mask", "mhid"] if masked else [])
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert_close(a.numpy(), np.asarray(b), TOL, name)


@pytest.mark.parametrize("masked", (True, False))
def test_plain_backward_matches_jax_run_bwd(masked):
    args, (dloc, dscale) = _case(masked, seed=1)
    img, wl, mi, mask, enc, head_w, head_b = args
    with _interpreted():
        res = jglimpse._run_fwd(*_tree(jnp.asarray, args), DIMS)
        saved = (res[2], res[3], res[4], res[1]) + tuple(res[5:])
        want = jglimpse._run_bwd(*_tree(jnp.asarray, (img, wl, mi, mask, enc, head_w)),
                                 saved, jnp.asarray(dloc), jnp.asarray(dscale), DIMS)
    got = fused_glimpse.glimpse_plain_bwd(
        *_torch((img, wl, mi, mask, enc, head_w)), _tree(lambda a: torch.tensor(
            np.asarray(a)), saved), torch.from_numpy(dloc), torch.from_numpy(dscale), DIMS)
    names = ["dwl"] + (["dmi", "dWm1", "dbm1", "dWm2", "dbm2"] if masked else []) + [
        "dWe1", "dbe1", "dWe2", "dbe2", "dWh", "dbh"]
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert float(np.max(np.abs(np.asarray(b)))) > 0, name
        assert_close(a.numpy(), np.asarray(b), TOL, name)


def _encoder(masked):
    enc = AIREncoder((H, W), (GH, GW), N_WHAT, Encoder(GH * GW, [D1, D2]), d_mask=D_MI,
                     masked_glimpse=masked)
    init_params(enc, torch.Generator().manual_seed(3))
    with torch.no_grad():  # nonzero biases: no exact elu zeros
        for name, p in enc.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
    return enc


def _encoder_grads(enc, img, wl, mi, ga, gb):
    wl = wl.clone().requires_grad_()
    leaves = [wl] + ([mi.clone().requires_grad_()] if mi is not None else [])
    leaves += list(enc.parameters())
    dist, glimpse = enc(img, wl, mask_inpt=leaves[1] if mi is not None else None)
    loss = torch.sum(dist.loc * ga) + torch.sum(dist.scale * gb)
    return [dist.loc, dist.scale], torch.autograd.grad(loss, leaves), glimpse


@pytest.mark.parametrize("masked", (True, False))
def test_switch_routes_the_encoder_through_the_function(masked, monkeypatch):
    """With SQAIR_FUSE_GLIMPSE the encoder's outputs and every gradient
    (where, mask input, weights) equal the unfused encoder's."""
    args, (ga, gb) = _case(masked, seed=2)
    img, wl = torch.from_numpy(args[0]), torch.from_numpy(args[1])
    mi = torch.from_numpy(args[2]) if masked else None
    enc = _encoder(masked)
    ga, gb = torch.from_numpy(ga), torch.from_numpy(gb)
    monkeypatch.delenv("SQAIR_FUSE_GLIMPSE", raising=False)
    want_out, want, glimpse = _encoder_grads(enc, img, wl, mi, ga, gb)
    assert glimpse is not None
    monkeypatch.setenv("SQAIR_FUSE_GLIMPSE", "1")
    calls = []
    real = fused_glimpse.glimpse_plain_bwd
    monkeypatch.setattr(fused_glimpse, "glimpse_plain_bwd",
                        lambda *a: calls.append(1) or real(*a))
    got_out, got, glimpse = _encoder_grads(enc, img, wl, mi, ga, gb)
    assert glimpse is None and calls == [1]
    for a, b in zip(got_out, want_out):
        assert_close(a.detach().numpy(), b.detach().numpy(), TOL, "output")
    names = ["where"] + (["mask_inpt"] if masked else []) + [n for n, _ in
                                                             enc.named_parameters()]
    assert len(names) == len(got) == len(want)
    for name, a, b in zip(names, got, want):
        size = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= TOL * size + 1e-7, f"{name}: {err:.3g} (largest {size:.3g})"


def test_slotted_where_and_deeper_encoders_stay_unfused(monkeypatch):
    """As in the JAX package: a [B, S, 4] where, or an encoder of other than
    two layers, runs the unfused chain even with the switch on."""
    monkeypatch.setenv("SQAIR_FUSE_GLIMPSE", "1")
    img = torch.rand(B, H, W)
    enc = _encoder(True)
    _, glimpse = enc(img, torch.randn(B, 2, 4), mask_inpt=torch.randn(B, 2, D_MI))
    assert glimpse is not None and glimpse.shape == (B, 2, GH, GW)
    deep = AIREncoder((H, W), (GH, GW), N_WHAT, Encoder(GH * GW, [D1, D1, D2]))
    init_params(deep, torch.Generator().manual_seed(0))
    _, glimpse = deep(img, torch.randn(B, 4))
    assert glimpse is not None


def test_function_passes_gradcheck_on_the_cpu():
    """The hand-written backward against finite differences in float64."""
    args, _ = _case(True, seed=6)
    img, wl, mi, mask, enc, head_w, head_b = _tree(
        lambda a: torch.from_numpy(a.astype(np.float64)), args)
    leaves = [wl, mi, *[t for wb in mask for t in wb], *[t for wb in enc for t in wb],
              head_w, head_b]
    leaves = [t.requires_grad_() for t in leaves]

    def fn(wl_, mi_, *flat):
        mp = ((flat[0], flat[1]), (flat[2], flat[3]))
        ep = ((flat[4], flat[5]), (flat[6], flat[7]))
        return fused_glimpse.fused_glimpse_encoder(img, wl_, mi_, mp, ep, flat[8], flat[9],
                                                   (GH, GW), N_WHAT)

    assert torch.autograd.gradcheck(fn, leaves, atol=1e-6, rtol=1e-4)


def test_wrappers_call_the_c_prototypes(monkeypatch):
    """The kernel calls pass ops/build.py's PROTOTYPES and the pointer tables
    that csrc/fused_glimpse.cu reads (20 forward, 29 backward entries), and
    count their launches (the library is a stand-in; CPU tensors pose as the
    card's)."""
    calls = []

    class FakeLibrary:
        def __getattr__(self, name):
            argtypes = build.PROTOTYPES[name]

            def call(*args):
                assert len(args) == len(argtypes), (name, len(args), len(argtypes))
                for a, t in zip(args, argtypes):
                    t.from_param(a)
                calls.append((name, len(args[0]), list(args[1])))
                return 0
            return call

    monkeypatch.setattr(build, "library", lambda: FakeLibrary())
    monkeypatch.setattr(fused_glimpse, "_stream", lambda device: ctypes.c_void_p(0))
    fused.reset_launches()
    for masked in (True, False):
        args, (dloc, dscale) = _case(masked)
        img, wl, mi, mask, enc, head_w, head_b = _torch(args)
        out = fused_glimpse._fwd_cuda(img, wl, mi, mask, enc, head_w, head_b, DIMS, save=True)
        assert len(out) == (7 if masked else 5)
        saved = out[2:5] + (out[1],) + out[5:]
        got = fused_glimpse._bwd_cuda(img, wl, mi, mask, enc, head_w, saved,
                                      torch.from_numpy(dloc), torch.from_numpy(dscale), DIMS)
        assert len(got) == (12 if masked else 7)
    kd_m = [B, H, W, GH, GW, D_MI, D_M, D1, D2, N_WHAT]
    kd_u = [B, H, W, GH, GW, 0, 0, D1, D2, N_WHAT]
    assert calls == [("sqair_fused_glimpse", 20, kd_m), ("sqair_fused_glimpse_bwd", 29, kd_m),
                     ("sqair_fused_glimpse", 20, kd_u), ("sqair_fused_glimpse_bwd", 29, kd_u)]
    assert fused.launches["fused_glimpse"] == 2 and fused.launches["fused_glimpse_bwd"] == 2


def test_the_cuda_request_raises_without_a_card(monkeypatch):
    """A tensor on the card goes to the kernel, never to the plain version:
    without a card the kernel library raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(fused_glimpse, "_on_cuda", lambda name, x: True)
    args, _ = _case(True)
    img, wl, mi, mask, enc, head_w, head_b = _torch(args)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        fused_glimpse.fused_glimpse_encoder(img, wl, mi, mask, enc, head_w, head_b, (GH, GW),
                                            N_WHAT)


def test_switches(monkeypatch):
    """SQAIR_FUSE_GLIMPSE is read as the JAX package reads it.  With
    SQAIR_FUSE_CELLS a model whose discovery the JAX package would fuse
    (kernels #7/#8: no early-discovery logit lever) loads and runs its
    discovery through the fused kernel; the release flags
    (early_disc_logit_scale 0.15) load with propagation fused and discovery
    unfused, as in JAX."""
    import json
    from pathlib import Path

    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.ops import fused_cells
    from sqair_tpu_torch.ops.noise import GeneratorNoise

    monkeypatch.delenv("SQAIR_FUSE_GLIMPSE", raising=False)
    assert not fused_glimpse.enabled()
    monkeypatch.setenv("SQAIR_FUSE_GLIMPSE", "1")
    assert fused_glimpse.enabled()
    monkeypatch.setenv("SQAIR_FUSE_CELLS", "1")
    model = mlp_mnist_model.load({"n_units": 1, "n_what": 4}, (24, 24), device="cpu")
    discover = model.sequence.timestep.discover
    assert discover.fused_disc_eligible()
    calls = []
    real = fused_cells.fused_disc_ssm
    monkeypatch.setattr(fused_cells, "fused_disc_ssm", lambda *a: calls.append(1) or real(*a))
    img = torch.rand(2, 24, 24, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = discover(img, torch.zeros(2, 32), 0, torch.zeros(2, 1),
                       GeneratorNoise(torch.Generator().manual_seed(1), "cpu"))
    assert len(calls) == 1 and out["what"].shape == (2, discover.n_steps, 4)
    release = Path(__file__).resolve().parent.parent / "release_models/mnist_mlp/1/flags.json"
    flags = dict(json.loads(release.read_text()), n_units=1, n_what=4)
    model = mlp_mnist_model.load(flags, (24, 24), device="cpu")
    ts = model.sequence.timestep
    assert not ts.discover.fused_disc_eligible()
    assert ts.propagate._fused_prop_params() is not None
