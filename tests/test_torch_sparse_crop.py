"""The index arithmetic of the crop at two pixels a row (csrc/glimpse_common.cuh
``sparse_crop_*``, the glimpse encoder's backward and the propagation
forward) against the dense interpolation matrices of
``ops/fused_glimpse.coords_and_interp``, in plain PyTorch on the CPU.

The kernels keep, for each row i of wy (and of wx), p0 = floor(u_i) and the
weights max(0, 1 - |u_i - p|) at p0 and p0 + 1 where those pixels lie in
the frame, and for each pixel h the range [lo_h, hi_h) of the rows i whose
two pixels hold h.  The dense matrices must be exactly those weights
scattered back (every other entry exactly 0), u must not fall with i, and
each range must hold every row with a non-zero weight at h: then the
kernels' sums, which drop only products whose weight is exactly 0, keep
the dense sums' bits.  Cases: many where logits drawn from a seed, a u on
an integer, a scale clipped at 1e-4, wheres that put part of the glimpse
outside the frame, and glimpses wider than the frame; at square shapes and
at the pedestrian configuration's non-square 64x48 frames and 32x12
glimpses (and with H and W, gh and gw swapped, where a swap of the two
would show).
"""
import numpy as np
import pytest
import torch

from sqair_tpu_torch.ops import fused_glimpse as fg


def _sparse(u, src):
    """(p0, w0, w1) of each row as the kernels form them (rows [B, n])."""
    p0 = torch.floor(u)
    w0 = torch.clamp(1.0 - torch.abs(u - p0), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs(u - (p0 + 1.0)), min=0.0)
    return p0.long(), w0, w1


def _scatter(p0, w0, w1, src):
    """The dense [B, n, src] matrix of the two weights of each row, pixels
    outside [0, src) dropped."""
    B, n = p0.shape
    out = torch.zeros(B, n, src, dtype=w0.dtype)
    for p, w in ((p0, w0), (p0 + 1, w1)):
        ok = (p >= 0) & (p < src)
        b, i = torch.nonzero(ok, as_tuple=True)
        out[b, i, p[b, i]] = w[b, i]
    return out


def _ranges(p0, src):
    """[lo_h, hi_h) of each pixel h: the first and one past the last row i
    with h in {p0_i, p0_i + 1} (lo = n, hi = 0 where none)."""
    B, n = p0.shape
    lo = torch.full((B, src), n, dtype=torch.long)
    hi = torch.zeros((B, src), dtype=torch.long)
    for i in range(n):
        for e in (0, 1):
            h = p0[:, i] + e
            ok = (h >= 0) & (h < src)
            b = torch.nonzero(ok, as_tuple=True)[0]
            lo[b, h[b]] = torch.minimum(lo[b, h[b]], torch.full_like(b, i))
            hi[b, h[b]] = i + 1
    return lo, hi


def _where_logits(n, seed):
    rng = np.random.default_rng(seed)
    wl = rng.normal(0.0, 1.5, size=(n, 4)).astype(np.float32)
    special = np.array([
        [30.0, 30.0, 0.0, 0.0],      # scale 1, shift 0: u_0 = 0 and u_last = src - 1
        [30.0, 30.0, 0.5, -0.5],
        [-20.0, -20.0, 0.3, -0.2],   # the scale clipped at 1e-4
        [-9.3, -9.1, 0.0, 0.0],      # just below the clip
        [0.0, 0.0, 2.0, -2.0],       # part of the glimpse past the frame's edges
        [3.0, 3.0, 3.0, 3.0],        # most of it outside
        [3.0, 3.0, -3.0, -3.0],
        [0.0, 0.0, 0.0, 0.0],
    ], dtype=np.float32)
    return torch.from_numpy(np.concatenate([special, wl]))


@pytest.mark.parametrize("H,W,gh,gw", [(50, 50, 20, 20), (12, 17, 5, 7), (8, 8, 20, 20),
                                      (64, 48, 32, 12), (48, 64, 12, 32), (40, 30, 16, 6)])
def test_two_nonzero_crop_indices_match_the_dense_interpolation(H, W, gh, gw):
    wl = _where_logits(500, seed=H * 100 + gh)
    _, (wy, uy, _), (wx, ux, _) = fg.coords_and_interp(wl, H, W, gh, gw)
    for u, dense, src in ((uy, wy, H), (ux, wx, W)):
        # u never falls with i (the scale is clipped at >= 1e-4)
        assert bool(torch.all(u[:, 1:] >= u[:, :-1]))
        p0, w0, w1 = _sparse(u, src)
        # the dense rows are exactly the two weights scattered back
        assert torch.equal(_scatter(p0, w0, w1, src), dense)
        assert bool(torch.all((dense > 0).sum(-1) <= 2))
        # every row with a non-zero weight at pixel h lies in [lo_h, hi_h),
        # and every row of that range holds h at p0 or p0 + 1
        lo, hi = _ranges(p0, src)
        rows = torch.arange(u.shape[1])[None, :, None]
        inside = (rows >= lo[:, None, :]) & (rows < hi[:, None, :])
        assert not bool(torch.any((dense > 0) & ~inside))
        holds = (p0[:, :, None] == torch.arange(src)) | (p0[:, :, None] + 1 == torch.arange(src))
        assert not bool(torch.any(inside & ~holds))


def test_the_cases_reach_the_edges():
    """The drawn where logits include a u exactly on an integer, a clipped
    scale and glimpses that reach past every edge of the frame."""
    H = W = 50
    wl = _where_logits(500, seed=H * 100 + 20)
    (sx, sy, _, _), (_, uy, _), (_, ux, _) = fg.coords_and_interp(wl, H, W, 20, 20)
    assert bool(torch.any(uy == torch.floor(uy))) and bool(torch.any(ux == torch.floor(ux)))
    assert bool(torch.any(sx < fg.MIN_SCALE)) and bool(torch.any(sy < fg.MIN_SCALE))
    for u, src in ((uy, H), (ux, W)):
        assert bool(torch.any(u < 0)) and bool(torch.any(u > src - 1))
