"""sqair_tpu_torch's CUDA kernels (the fused MLP, the two cells, the fused
glimpse encoder and the fused propagation and discovery unrolls) against
their plain versions on the card.

Needs a CUDA device (skips without one) and imports no JAX, so that it runs
on a machine without it; the root conftest.py imports JAX, so run it there
with ``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.
Forward tolerance 1e-5 abs + 1e-4 rel: the same f32 sums in another order.
Backward tolerance 1e-4 of each gradient's largest magnitude (+1e-6): the
weight gradients sum up to N products in another order than cuBLAS, and
small entries of a sum with cancellation carry the error of the large ones.
"""
from unittest import mock

import pytest
import torch

from sqair_tpu_torch.ops import fused


def _rnd_fn(gen):
    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda") / s[0] ** 0.5
    return rnd


def _assert_grads_close(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None:
            assert a is None, (what, i)
            continue
        tol = 1e-4 * float(b.abs().max()) + 1e-6
        err = float((a - b).abs().max())
        assert err <= tol, f"{what} gradient {i}: {err:.3g} > {tol:.3g}"


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """Each forward kernel against its plain version on the card (skips
    without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = _rnd_fn(gen)

    with torch.inference_mode():
        x, h = torch.rand(100, 300, generator=gen, device="cuda"), rnd(100, 64)
        params = [(rnd(300, 256), rnd(256)), (rnd(256, 64), rnd(64))]
        for acts in (("elu", "sigmoid"), ("tanh", "id")):
            torch.testing.assert_close(fused.fused_mlp(x, params, acts),
                                       fused.mlp_plain(x, params, acts),
                                       rtol=1e-4, atol=1e-5)
        v = (x, h, rnd(300, 64), rnd(64, 64), rnd(64))
        torch.testing.assert_close(fused.fused_vanilla_rnn(*v), fused.vanilla_rnn_plain(*v),
                                   rtol=1e-4, atol=1e-5)
        g = (x, h, rnd(300, 128), rnd(64, 128), rnd(128), rnd(300, 64), rnd(64, 64), rnd(64))
        torch.testing.assert_close(fused.fused_gru(*g), fused.gru_plain(*g),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 160, 4800])
def test_backward_kernels_match_plain_on_cuda(n):
    """Each backward kernel against its plain version on the card, at a
    ragged row count, the time loop's and the deferred decode's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(n)
    rnd = _rnd_fn(gen)
    x = torch.rand(n, 300, generator=gen, device="cuda")
    for acts in (("elu", "elu", "id"), ("sigmoid", "tanh", "elu")):
        params = [(rnd(300, 256), rnd(256)), (rnd(256, 130), rnd(130)), (rnd(130, 400), rnd(400))]
        a = fused.mlp_plain_acts(x, params, acts)
        gy = rnd(n, 400)
        got = fused.fused_mlp_bwd(x, params, acts, a, gy)
        want = fused.mlp_bwd_plain(x, params, acts, a, gy)
        _assert_grads_close([got[0], *[t for p in got[1] for t in p]],
                            [want[0], *[t for p in want[1] for t in p]], f"mlp {acts}")
    h, gh = 2 * torch.rand(n, 256, generator=gen, device="cuda") - 1, rnd(n, 256)
    w, u, b = rnd(300, 256), rnd(256, 256), rnd(256)
    hn = fused.vanilla_rnn_plain(x, h, w, u, b)
    _assert_grads_close(fused.fused_vanilla_rnn_bwd(x, h, w, u, hn, gh),
                        fused.vanilla_rnn_bwd_plain(x, h, w, u, hn, gh), "vanilla rnn")
    wg, ug, bg, wc, uc, bc = rnd(300, 512), rnd(256, 512), rnd(512), rnd(300, 256), \
        rnd(256, 256), rnd(256)
    _, zr, c = fused.gru_plain_saving(x, h, wg, ug, bg, wc, uc, bc)
    _assert_grads_close(fused.fused_gru_bwd(x, h, wg, ug, wc, uc, zr, c, gh),
                        fused.gru_bwd_plain(x, h, wg, ug, wc, uc, zr, c, gh), "gru")


@pytest.mark.cuda
def test_autograd_on_cuda_launches_the_backward_kernels():
    """A CUDA tensor that needs a gradient goes through the backward kernel
    (and is counted), and its gradients match plain autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = _rnd_fn(gen)
    x = torch.rand(37, 20, generator=gen, device="cuda")
    h = rnd(37, 16).requires_grad_()
    mats = [rnd(20, 32), rnd(16, 32), rnd(32), rnd(20, 16), rnd(16, 16), rnd(16),
            rnd(20, 32), rnd(32)]
    leaves = [h] + [m.requires_grad_() for m in mats]

    def loss(mlp, gru):
        y = mlp(x, [(leaves[7], leaves[8])], ["elu"])
        hn = gru(y[:, :20].contiguous(), h, *leaves[1:7])
        return torch.sum(hn * hn)

    fused.reset_launches()
    got = torch.autograd.grad(loss(fused.fused_mlp, fused.fused_gru), leaves)
    torch.cuda.synchronize()
    assert fused.launches["fused_mlp_bwd"] == 1 and fused.launches["fused_gru_bwd"] == 1
    want = torch.autograd.grad(loss(fused.mlp_plain, fused.gru_plain), leaves)
    _assert_grads_close(got, want, "autograd")


def _glimpse_case(gen, n, masked):
    """Inputs of one glimpse call at the release model's widths."""
    rnd = _rnd_fn(gen)
    img = torch.rand(n, 50, 50, generator=gen, device="cuda")
    wl = torch.randn(n, 4, generator=gen, device="cuda")
    mi = torch.randn(n, 256, generator=gen, device="cuda") if masked else None
    mask = ((rnd(256, 128), rnd(128)), (rnd(128, 400), 1 + rnd(400))) if masked else None
    enc = ((rnd(400, 256), rnd(256)), (rnd(256, 256), rnd(256)))
    return img, wl, mi, mask, enc, rnd(256, 100), rnd(100)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", (True, False))
@pytest.mark.parametrize("n", [13, 160])
def test_glimpse_kernels_match_plain_on_cuda(n, masked):
    """The fused glimpse forward (every output, the saved tensors included)
    and backward (every gradient, where's included) against their plain
    versions, at a ragged row count and the release model's 160 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sqair_tpu_torch.ops import fused_glimpse as fg

    gen = torch.Generator(device="cuda").manual_seed(n + masked)
    args = _glimpse_case(gen, n, masked)
    dims = (20, 20, 50)
    with torch.inference_mode():
        got = fg._fwd_cuda(*args, dims, save=True)
        want = fg.glimpse_plain_fwd(*args, dims)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        saved = want[2:5] + (want[1],) + tuple(want[5:])
        dloc = torch.randn(n, 50, generator=gen, device="cuda")
        dscale = torch.randn(n, 50, generator=gen, device="cuda")
        img, wl, mi, mask, enc, head_w, _ = args
        _assert_grads_close(
            fg.fused_glimpse_bwd(img, wl, mi, mask, enc, head_w, saved, dloc, dscale, dims),
            fg.glimpse_plain_bwd(img, wl, mi, mask, enc, head_w, saved, dloc, dscale, dims),
            f"glimpse masked={masked}")


@pytest.mark.cuda
def test_glimpse_autograd_on_cuda_launches_both_kernels():
    """The model's entry point on CUDA tensors that need a gradient goes
    through the forward and the backward kernel, once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sqair_tpu_torch.ops import fused_glimpse as fg

    gen = torch.Generator(device="cuda").manual_seed(7)
    img, wl, mi, mask, enc, head_w, head_b = _glimpse_case(gen, 37, True)
    leaves = [wl, mi, *[t for wb in mask for t in wb], *[t for wb in enc for t in wb],
              head_w, head_b]
    for t in leaves:
        t.requires_grad_()

    def loss(fn):
        loc, scale = fn(img, wl, mi, mask, enc, head_w, head_b)
        return torch.sum(loc * loc) + torch.sum(scale)

    fused.reset_launches()
    got = torch.autograd.grad(
        loss(lambda *a: fg.fused_glimpse_encoder(*a, (20, 20), 50)), leaves)
    torch.cuda.synchronize()
    assert fused.launches["fused_glimpse"] == 1 and fused.launches["fused_glimpse_bwd"] == 1
    want = torch.autograd.grad(loss(lambda *a: fg.glimpse_plain_fwd(*a, (20, 20, 50))[:2]),
                               leaves)
    _assert_grads_close(got, want, "glimpse autograd")


def _prop_case(n):
    """Inputs of one fused propagation call at the release model's widths
    (chip_smoke.prop_inputs), and its dims."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from sqair_tpu_torch.ops import fused_cells as fc

    shape = dict(n=n, S=3, img=[50, 50], glimpse=[20, 20], n_what=50, U=256, SP=128, WB=128,
                 MH=128)
    gen = torch.Generator(device="cuda").manual_seed(n)
    args, weights = chip_smoke.prop_inputs(torch, fc, shape, gen, "cuda")
    return fc, args, weights, chip_smoke.prop_dims(shape), gen


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 160])
def test_prop_kernels_match_plain_on_cuda(n):
    """The fused propagation forward (the ten outputs and the residual rows)
    and backward (every input's and weight's gradient) against their plain
    versions, at a ragged row count and the release model's 160 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, gen = _prop_case(n)
    with torch.inference_mode():
        got = fc._fwd_cuda(*args, weights, dims)
        want = fc.prop_plain_fwd(*args, weights, dims)
        assert len(got) == len(want) == 11
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        cots = tuple(torch.randn(t.shape, generator=gen, device="cuda") for t in want[:10])
        saved = (want[0], want[2], want[3], want[5], want[6], want[7], want[9])
        bargs = (*args, weights, saved, want[10], cots, dims)
        _assert_grads_close(fc._bwd_cuda(*bargs), fc.prop_plain_bwd(*bargs), "prop")
        # with both crops' where-gradients cut out of some row-slots
        keep = (torch.rand((dims[0], n), generator=gen, device="cuda") < 0.5).float()
        _assert_grads_close(fc._bwd_cuda(*bargs, crop_keep=keep),
                            fc.prop_plain_bwd(*bargs, crop_keep=keep), "prop, crop_keep")


@pytest.mark.cuda
def test_prop_autograd_on_cuda_launches_both_kernels():
    """The entry point on CUDA tensors that need a gradient goes through the
    forward and the backward kernel, once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, gen = _prop_case(37)
    leaves = [t.requires_grad_() for t in args[1:6] + weights]

    def loss(fwd):
        out = fwd(args[0], *leaves[:5], *args[6:], tuple(leaves[5:]), dims)
        return sum(torch.sum(o * o) for o in out[:10])

    fused.reset_launches()
    got = torch.autograd.grad(loss(lambda *a: fc._PropFunction.apply(a[-1], *a[:9], *a[9])),
                              leaves)
    torch.cuda.synchronize()
    assert fused.launches["fused_prop"] == 1 and fused.launches["fused_prop_bwd"] == 1
    with mock.patch.multiple(fc, _fwd_cuda=fc.prop_plain_fwd, _bwd_cuda=fc.prop_plain_bwd):
        want = torch.autograd.grad(
            loss(lambda *a: fc._PropFunction.apply(a[-1], *a[:9], *a[9])), leaves)
    _assert_grads_close(got, want, "prop autograd")


def _disc_case(n):
    """Inputs of one fused discovery call at the release model's widths on
    frames of the port's data generator (chip_smoke.disc_inputs), and its
    dims."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from sqair_tpu_torch.data import create_seq_dataset, make_template_bank
    from sqair_tpu_torch.ops import fused_cells as fc

    shape = dict(n=n, S=3, img=[50, 50], glimpse=[20, 20], n_what=50, U=256, SP=128, C=256)
    frames = create_seq_dataset(n_samples=-(-n // 10), n_timesteps=10, canvas_size=(50, 50),
                                obj_size=(28, 28), n_objects=(0, 2), seed=n,
                                templates=make_template_bank(256, 28, seed=0))["imgs"]
    frames = torch.from_numpy(frames.reshape(-1, 50, 50).astype("float32") / 255.0)
    gen = torch.Generator(device="cuda").manual_seed(n)
    args, weights = chip_smoke.disc_inputs(torch, fc, shape, gen, "cuda", frames)
    return fc, args, weights, chip_smoke.disc_dims(shape), gen


@pytest.mark.cuda
@pytest.mark.parametrize("n", [13, 160])
def test_disc_kernels_match_plain_on_cuda(n):
    """The fused discovery forward (the nine outputs, the residual rows, the
    glimpses and the input encoder's layers) and backward (every input's and
    weight's gradient) against their plain versions, at a ragged row count
    and the release model's 160 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, gen = _disc_case(n)
    with torch.inference_mode():
        got = fc._disc_fwd_cuda(*args, weights, dims)
        want = fc.disc_plain_fwd(*args, weights, dims)
        assert len(got) == len(want) == 12
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        cots = tuple(torch.randn(t.shape, generator=gen, device="cuda") for t in want[:9])
        saved = (want[0], want[2], want[3], want[5], want[6], want[7])
        bargs = (*args, weights, saved, want[9], want[10], want[11], cots, dims)
        _assert_grads_close(fc._disc_bwd_cuda(*bargs), fc.disc_plain_bwd(*bargs), "disc")
        # with the crop's where-gradient cut out of some row-slots
        keep = (torch.rand((dims[0], n), generator=gen, device="cuda") < 0.5).float()
        _assert_grads_close(fc._disc_bwd_cuda(*bargs, crop_keep=keep),
                            fc.disc_plain_bwd(*bargs, crop_keep=keep), "disc, crop_keep")


@pytest.mark.cuda
def test_disc_autograd_on_cuda_launches_both_kernels():
    """The entry point on CUDA tensors that need a gradient goes through the
    forward and the backward kernel, once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, gen = _disc_case(37)
    leaves = [t.requires_grad_() for t in args[2:4] + weights]

    def loss():
        out = fc._DiscFunction.apply(dims, *args[:2], *leaves[:2], *args[4:], *leaves[2:])
        return sum(torch.sum(o * o) for o in out)

    fused.reset_launches()
    got = torch.autograd.grad(loss(), leaves)
    torch.cuda.synchronize()
    assert fused.launches["fused_disc"] == 1 and fused.launches["fused_disc_bwd"] == 1
    with mock.patch.multiple(fc, _disc_fwd_cuda=fc.disc_plain_fwd,
                             _disc_bwd_cuda=fc.disc_plain_bwd):
        want = torch.autograd.grad(loss(), leaves)
    _assert_grads_close(got, want, "disc autograd")


# MLP stacks for the redesigned forward: d_in 2500, widths 1024 and 1, 1-4
# layers (each crosses a tile edge of csrc/fused_mlp.cu: a 32-column chunk,
# a cluster's share of columns, a 32-row K-block, an 8-row tile)
_MLP_STACKS = (([1024], ("elu",)),
               ([1024, 1], ("elu", "id")),
               ([256, 1024, 8], ("tanh", "sigmoid", "id")),
               ([1, 1024, 400, 1024], ("elu", "elu", "tanh", "sigmoid")))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 13, 160, 4800])
def test_mlp_forward_kernel_tiles_match_plain_on_cuda(n):
    """The cluster MLP forward against its plain version (1e-5 + 1e-4|v|) at
    tile-edge shapes, every saved post-activation included, with and
    without `saved`; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(n)
    rnd = _rnd_fn(gen)
    x = torch.rand(n, 2500, generator=gen, device="cuda")
    with torch.inference_mode():
        for widths, acts in _MLP_STACKS:
            dims = [2500] + widths
            params = [(rnd(a, b), 0.1 * rnd(b)) for a, b in zip(dims[:-1], dims[1:])]
            want = fused.mlp_plain_acts(x, params, acts)
            for save in (False, True):
                got = fused._mlp_fwd_cuda(x, params, acts, save=save)
                again = fused._mlp_fwd_cuda(x, params, acts, save=save)
                for i, (a, b, w) in enumerate(zip(got, again, want)):
                    if not save and i < len(want) - 1:
                        assert a is None and b is None
                        continue
                    torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5,
                                               msg=f"{dims} save={save} layer {i}")
                    assert torch.equal(a, b), f"{dims} save={save} layer {i}: two runs differ"


# One layer of long K (ops/fused.py is_long_k): the conv encoders' two
# shapes and a ragged K and width at 1-160 rows, and the path's own limits,
# the widest layer at the fewest inputs (at one row tile: two take too many
# blocks)
_LONG_K_CASES = ([(k, d, act, n)
                  for k, d, act in ((1600, 256, "id"), (fused.LONG_K_MAX, 256, "id"),
                                    (1030, 100, "elu"))
                  for n in (1, 7, 33, fused.LONG_K_MAX_ROWS)]
                 + [(fused.LONG_K_MIN, fused.LONG_K_MAX_WIDTH, "tanh", n) for n in (1, 7, 32)])


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,act,n", _LONG_K_CASES)
def test_long_k_kernels_match_plain_on_cuda(k, d, act, n):
    """The long-K forward and backward against their plain versions (forward
    1e-5 + 1e-4|v|, backward 1e-4 of each gradient's largest entry), the
    backward with and without dx; a second run gives the same bits, and
    ``long_k_calls`` shows that the long-K kernels ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert fused.is_long_k(n, [k, d])
    gen = torch.Generator(device="cuda").manual_seed(n * 7 + k)
    rnd = _rnd_fn(gen)
    x = torch.rand(n, k, generator=gen, device="cuda")
    params, acts = [(rnd(k, d), 0.1 * rnd(d))], (act,)
    g = rnd(n, d)
    fused.reset_launches()
    with torch.inference_mode():
        want = fused.mlp_plain_acts(x, params, acts)
        got, again = (fused._mlp_fwd_cuda(x, params, acts, save=True) for _ in range(2))
        torch.testing.assert_close(got[-1], want[-1], rtol=1e-4, atol=1e-5)
        assert torch.equal(got[-1], again[-1]), "two forward runs differ"
        want = fused.mlp_bwd_plain(x, params, acts, want, g)
        want = [want[0], *want[1][0]]
        for need_dx in (True, False):
            what = f"n={n} {k}->{d} dx={need_dx}"
            runs = [fused.fused_mlp_bwd(x, params, acts, got, g, need_dx=need_dx)
                    for _ in range(2)]
            runs = [[dx, *dwb] for dx, (dwb,) in runs]
            _assert_grads_close(runs[0], [want[0] if need_dx else None, *want[1:]], what)
            for a, b in zip(*runs):
                assert (a is None and b is None) or torch.equal(a, b), what
    assert dict(fused.long_k_calls) == {"fused_mlp": 2, "fused_mlp_bwd": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 13, 160, 1600])
def test_vrnn_backward_kernel_tiles_match_plain_on_cuda(n):
    """The one-launch vanilla-RNN backward against its plain version (1e-4
    of each gradient's largest entry) for d_x in {4, 416, 567}, units in
    {4, 256} and each choice of dx and dh; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(n)
    rnd = _rnd_fn(gen)
    with torch.inference_mode():
        for d_x in (4, 416, 567):
            for units in (4, 256):
                x = torch.rand(n, d_x, generator=gen, device="cuda")
                h = 2 * torch.rand(n, units, generator=gen, device="cuda") - 1
                w, u, b = rnd(d_x, units), rnd(units, units), rnd(units)
                hn = fused.vanilla_rnn_plain(x, h, w, u, b)
                g = rnd(n, units)
                want = fused.vanilla_rnn_bwd_plain(x, h, w, u, hn, g)
                for need_dx in (True, False):
                    for need_dh in (True, False):
                        what = f"vrnn d_x={d_x} units={units} dx={need_dx} dh={need_dh}"
                        got = fused.fused_vanilla_rnn_bwd(x, h, w, u, hn, g, need_dx, need_dh)
                        again = fused.fused_vanilla_rnn_bwd(x, h, w, u, hn, g, need_dx, need_dh)
                        skip = [i for i, need in ((0, need_dx), (1, need_dh)) if not need]
                        _assert_grads_close(
                            got, [None if i in skip else t for i, t in enumerate(want)], what)
                        for a, c in zip(got, again):
                            assert (a is None and c is None) or torch.equal(a, c), what


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 9, 159, 160, 161, 479, 480, 1600])
def test_cell_forward_kernels_tiles_match_plain_on_cuda(n):
    """The split-column vanilla-RNN and GRU forwards against their plain
    versions (1e-5 + 1e-4|v|) at tile edges: an 8-row tile, a 32-wide
    K-block of x (d_x 31-33) and the main path's d_x; units 4 and 256 (and
    512 for the vanilla RNN); the GRU's saved zr and c included, and without
    them.  A second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(n)
    rnd = _rnd_fn(gen)
    with torch.inference_mode():
        for d_x in (4, 31, 32, 33, 54, 360, 416, 567):
            for units in (4, 256, 512):
                x = torch.rand(n, d_x, generator=gen, device="cuda")
                h = 2 * torch.rand(n, units, generator=gen, device="cuda") - 1
                what = f"n={n} d_x={d_x} units={units}"
                v = (x, h, rnd(d_x, units), rnd(units, units), 0.1 * rnd(units))
                got = fused._vrnn_fwd_cuda(*v)
                torch.testing.assert_close(got, fused.vanilla_rnn_plain(*v), rtol=1e-4,
                                           atol=1e-5, msg=f"vrnn {what}")
                assert torch.equal(got, fused._vrnn_fwd_cuda(*v)), f"vrnn {what}: two runs differ"
                if units > 256:
                    continue
                g = (x, h, rnd(d_x, 2 * units), rnd(units, 2 * units), 0.1 * rnd(2 * units),
                     rnd(d_x, units), rnd(units, units), 0.1 * rnd(units))
                want = fused.gru_plain_saving(*g)
                got = fused._gru_fwd_cuda(*g, save=True)
                again = fused._gru_fwd_cuda(*g, save=True)
                for i, (a, b, w) in enumerate(zip(got, again, want)):
                    torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5,
                                               msg=f"gru {what} output {i}")
                    assert torch.equal(a, b), f"gru {what} output {i}: two runs differ"
                hn, zr, c = fused._gru_fwd_cuda(*g, save=False)
                assert zr is None and c is None
                assert torch.equal(hn, got[0]), f"gru {what}: save=False differs"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 9, 161, 4800])
def test_mlp_backward_kernel_tiles_match_plain_on_cuda(n):
    """The cluster MLP backward and its tile reducer against the plain
    backward (1e-4 of each gradient's largest entry) at tile edges: d_in
    2500 and 1, widths 1024 and 1, 1-4 layers (an 8-row tile, a 32-column
    chunk, a cluster's share of chunks, a 32-wide block of j, a 32-row chunk
    of the reducer), with and without dx; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(n)
    rnd = _rnd_fn(gen)
    with torch.inference_mode():
        for d_in in (2500, 1):
            x = torch.rand(n, d_in, generator=gen, device="cuda")
            for widths, acts in _MLP_STACKS:
                dims = [d_in] + widths
                params = [(rnd(a, b), 0.1 * rnd(b)) for a, b in zip(dims[:-1], dims[1:])]
                saved = fused.mlp_plain_acts(x, params, acts)
                g = rnd(n, dims[-1])
                want = fused.mlp_bwd_plain(x, params, acts, saved, g)
                want = [want[0], *[t for p in want[1] for t in p]]
                for need_dx in (True, False):
                    what = f"n={n} dims={dims} dx={need_dx}"
                    got, again = (fused.fused_mlp_bwd(x, params, acts, saved, g, need_dx=need_dx)
                                  for _ in range(2))
                    got = [got[0], *[t for p in got[1] for t in p]]
                    again = [again[0], *[t for p in again[1] for t in p]]
                    _assert_grads_close(got, [want[0] if need_dx else None, *want[1:]], what)
                    for a, b in zip(got, again):
                        assert (a is None and b is None) or torch.equal(a, b), what


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 161])
def test_prop_backward_kernel_tiles_match_plain_on_cuda(n):
    """The cluster propagation backward and its tile reducer against the
    plain backward at row counts at the edges of the 8-row tiles and of the
    cluster (1, 3: one tile, clusters of 8; 161: 21 tiles, clusters of 4),
    with and without crop_keep; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, gen = _prop_case(n)
    with torch.inference_mode():
        fwd = fc.prop_plain_fwd(*args, weights, dims)
        cots = tuple(torch.randn(t.shape, generator=gen, device="cuda") for t in fwd[:10])
        saved = (fwd[0], fwd[2], fwd[3], fwd[5], fwd[6], fwd[7], fwd[9])
        bargs = (*args, weights, saved, fwd[10], cots, dims)
        keep = (torch.rand((dims[0], n), generator=gen, device="cuda") < 0.5).float()
        for kp in (None, keep):
            got = fc._bwd_cuda(*bargs, crop_keep=kp)
            again = fc._bwd_cuda(*bargs, crop_keep=kp)
            what = f"prop n={n} crop_keep={kp is not None}"
            _assert_grads_close(got, fc.prop_plain_bwd(*bargs, crop_keep=kp), what)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("masked", (True, False))
@pytest.mark.parametrize("n", [1, 7, 9, 160, 161])
def test_glimpse_backward_kernel_tiles_match_plain_on_cuda(n, masked):
    """The cluster glimpse backward (its crops at the two non-zeros of each
    interpolation row) and its tile reducer against the plain backward at
    row counts at the edges of the 8-row tiles and of the cluster (1, 7:
    one tile, clusters of 8; 9: two; 160, 161: clusters of 4), masked and
    unmasked; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sqair_tpu_torch.ops import fused_glimpse as fg

    gen = torch.Generator(device="cuda").manual_seed(100 + n + masked)
    args = _glimpse_case(gen, n, masked)
    dims = (20, 20, 50)
    with torch.inference_mode():
        want = fg.glimpse_plain_fwd(*args, dims)
        saved = want[2:5] + (want[1],) + tuple(want[5:])
        dloc = torch.randn(n, 50, generator=gen, device="cuda")
        dscale = torch.randn(n, 50, generator=gen, device="cuda")
        bargs = (*args[:6], saved, dloc, dscale, dims)
        got, again = (fg.fused_glimpse_bwd(*bargs) for _ in range(2))
        what = f"glimpse n={n} masked={masked}"
        _assert_grads_close(got, fg.glimpse_plain_bwd(*bargs), what)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 161])
def test_prop_forward_kernel_tiles_match_plain_on_cuda(n):
    """The cluster propagation forward (every output and residual field)
    against the plain forward at row counts at the edges of the 8-row tiles
    and of the cluster (1, 3: one tile, clusters of 8; 161: 21 tiles,
    clusters of 4); a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, _ = _prop_case(n)
    with torch.inference_mode():
        got, again = (fc._fwd_cuda(*args, weights, dims) for _ in range(2))
        want = fc.prop_plain_fwd(*args, weights, dims)
        assert len(got) == len(want) == 11
        for i, (a, b) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=f"prop n={n} output {i}")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"prop n={n}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("masked", (True, False))
@pytest.mark.parametrize("n", [1, 7, 9, 160, 161])
def test_glimpse_forward_kernel_tiles_match_plain_on_cuda(n, masked):
    """The cluster glimpse forward (its crops at the two non-zeros of each
    interpolation row; every output, the saved tensors included) against
    the plain forward at row counts at the edges of the 8-row tiles and of
    the cluster (1, 7: one tile, clusters of 8; 9: two; 160, 161: clusters
    of 4), masked and unmasked; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sqair_tpu_torch.ops import fused_glimpse as fg

    gen = torch.Generator(device="cuda").manual_seed(200 + n + masked)
    args = _glimpse_case(gen, n, masked)
    dims = (20, 20, 50)
    with torch.inference_mode():
        got, again = (fg._fwd_cuda(*args, dims, save=True) for _ in range(2))
        want = fg.glimpse_plain_fwd(*args, dims)
        assert len(got) == len(want)
        what = f"glimpse n={n} masked={masked}"
        for i, (a, b) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=f"{what} output {i}")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 9, 160, 161])
def test_disc_backward_kernel_tiles_match_plain_on_cuda(n):
    """The cluster discovery backward (its crops at the two non-zeros of
    each interpolation row) and its tile reducer against the plain backward
    at row counts at the edges of the 8-row tiles and of the cluster (1, 3:
    one tile, clusters of 8; 9: two; 160, 161: clusters of 4), with and
    without crop_keep; a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, gen = _disc_case(n)
    with torch.inference_mode():
        fwd = fc.disc_plain_fwd(*args, weights, dims)
        cots = tuple(torch.randn(t.shape, generator=gen, device="cuda") for t in fwd[:9])
        saved = (fwd[0], fwd[2], fwd[3], fwd[5], fwd[6], fwd[7])
        bargs = (*args, weights, saved, fwd[9], fwd[10], fwd[11], cots, dims)
        keep = (torch.rand((dims[0], n), generator=gen, device="cuda") < 0.5).float()
        for kp in (None, keep):
            got = fc._disc_bwd_cuda(*bargs, crop_keep=kp)
            again = fc._disc_bwd_cuda(*bargs, crop_keep=kp)
            what = f"disc n={n} crop_keep={kp is not None}"
            _assert_grads_close(got, fc.disc_plain_bwd(*bargs, crop_keep=kp), what)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx,need_dh", [(True, True), (True, False), (False, True),
                                             (False, False)])
@pytest.mark.parametrize("n", [1, 7, 9, 160, 161, 480, 481])
def test_gru_backward_kernel_tiles_match_plain_on_cuda(n, need_dx, need_dh):
    """The cluster GRU backward and its tile reducer against the plain
    backward (1e-4 of each gradient's largest entry) at row counts at the
    edges of the 8-row tiles and of the cluster (1, 7: one tile; 9: two;
    160, 161: clusters of 8; 480, 481: clusters of 4), at the temporal
    cell's widths (d_x 360) and the propagation prior's (d_x 54, at 480
    rows), each of dx and dh asked or not; a second run gives the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(300 + n)
    rnd = _rnd_fn(gen)
    d_x, units = (54 if n >= 480 else 360), 256
    x = torch.rand(n, d_x, generator=gen, device="cuda")
    h = 2 * torch.rand(n, units, generator=gen, device="cuda") - 1
    wg, ug, bg = rnd(d_x, 2 * units), rnd(units, 2 * units), rnd(2 * units)
    wc, uc, bc = rnd(d_x, units), rnd(units, units), rnd(units)
    with torch.inference_mode():
        _, zr, c = fused.gru_plain_saving(x, h, wg, ug, bg, wc, uc, bc)
        g = rnd(n, units)
        bargs = (x, h, wg, ug, wc, uc, zr, c, g)
        want = list(fused.gru_bwd_plain(*bargs))
        want[0] = want[0] if need_dx else None
        want[1] = want[1] if need_dh else None
        got, again = (fused.fused_gru_bwd(*bargs, need_dx=need_dx, need_dh=need_dh)
                      for _ in range(2))
        what = f"gru n={n} dx={need_dx} dh={need_dh}"
        _assert_grads_close(got, want, what)
        for a, b in zip(got, again):
            assert (a is None and b is None) or torch.equal(a, b), f"{what}: two runs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 9, 160, 161])
def test_disc_forward_kernel_tiles_match_plain_on_cuda(n):
    """The cluster discovery forward (its input encoder fused_mlp.cu's
    kernel; its crops at the two non-zeros of each interpolation row; the
    nine outputs, the residual rows, the glimpses and the input encoder's
    layers) against the plain forward at row counts at the edges of the
    8-row tiles and of the cluster (1, 3: one tile, clusters of 8; 9: two;
    160, 161: clusters of 4); a second run gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fc, args, weights, dims, _ = _disc_case(n)
    with torch.inference_mode():
        got, again = (fc._disc_fwd_cuda(*args, weights, dims) for _ in range(2))
        want = fc.disc_plain_fwd(*args, weights, dims)
        assert len(got) == len(want) == 12
        for i, (a, b) in enumerate(zip(got, want)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=f"disc n={n} output {i}")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"disc n={n}: two runs differ"
