"""Fused MLP and recurrent-cell kernels, forward and backward, with their
plain versions.

Each function here computes what a Pallas TPU kernel of
``sqair_tpu/ops/fused.py`` computes:

  fused_mlp          act_n(... act_1(x W_1 + b_1) ... W_n + b_n)
  fused_vanilla_rnn  h' = tanh(x W + h U + b)
  fused_gru          zr = sigmoid(x Wg + h Ug + bg); z, r = split(zr)
                     c = tanh(x Wc + (r h) Uc + bc); h' = (1 - z) h + z c

and each has a hand-written backward, as the JAX package's custom VJPs do.
On a CUDA tensor the wrapper launches the kernels of ``sqair_tpu_torch/csrc``
(built by ``ops/build.py``) or raises; on a CPU tensor it runs the plain
PyTorch versions beside them.  A call that needs a gradient goes through a
``torch.autograd.Function`` whose forward saves what the JAX package's
``_fused_fwd`` / ``_fused_vrnn_fwd`` / ``_fused_gru_fwd`` save and whose
backward launches the backward kernel (on the CPU: runs the plain backward).
``launches`` counts the calls of each wrapper that launched its kernels:
``fused_mlp``, ``fused_vanilla_rnn`` and ``fused_gru`` for the forwards,
and the same names with ``_bwd`` for the backwards (one count per call,
however many CUDA launches the call makes).  ``long_k_calls`` counts, under
``fused_mlp`` and ``fused_mlp_bwd``, the calls among them that took the
long-K kernels (``is_long_k``).
"""
from __future__ import annotations

import collections
import ctypes
from typing import Sequence, Tuple

import torch

ACTS = ("id", "elu", "sigmoid", "tanh")
MAX_LAYERS = 4  # csrc/fused_mlp.cu kMaxLayers
MAX_WIDTH = 1024  # csrc/common.cuh kMaxWidth
SMS = 132  # streaming multiprocessors of an H100 SXM: the blocks a launch should fill
MAX_SMEM = 232448  # dynamic shared memory a block may take on Hopper (227 KB)

launches = collections.Counter()
long_k_calls = collections.Counter()


def reset_launches():
    launches.clear()
    long_k_calls.clear()


def apply_act(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "elu":
        # the JAX package's form (ops/fused.py _apply_act)
        return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "tanh":
        return torch.tanh(z)
    return z


def act_grad_from_output(a: torch.Tensor, act: str) -> torch.Tensor:
    """d act(z) / dz written with the post-activation a (elu: 1 for a > 0,
    else a + 1; sigmoid: a (1 - a); tanh: 1 - a^2)."""
    if act == "elu":
        return torch.where(a > 0, torch.ones_like(a), a + 1.0)
    if act == "sigmoid":
        return a * (1.0 - a)
    if act == "tanh":
        return 1.0 - a * a
    return torch.ones_like(a)


# ------------------------------------------------------------ plain versions
def mlp_plain_acts(x, params, transfers):
    """Every layer's post-activation, the last one being the output."""
    acts = []
    for (w, b), act in zip(params, transfers):
        x = apply_act(x @ w + b, act)
        acts.append(x)
    return acts


def mlp_plain(x, params, transfers):
    return mlp_plain_acts(x, params, transfers)[-1]


def vanilla_rnn_plain(x, h, w, u, b):
    return torch.tanh(x @ w + h @ u + b)


def gru_plain_saving(x, h, wg, ug, bg, wc, uc, bc):
    """(h', zr, c): the output and what the backward needs."""
    zr = torch.sigmoid(x @ wg + h @ ug + bg)
    u_dim = h.shape[-1]
    z, r = zr[..., :u_dim], zr[..., u_dim:]
    c = torch.tanh(x @ wc + (r * h) @ uc + bc)
    return (1.0 - z) * h + z * c, zr, c


def gru_plain(x, h, wg, ug, bg, wc, uc, bc):
    return gru_plain_saving(x, h, wg, ug, bg, wc, uc, bc)[0]


def mlp_bwd_plain(x, params, transfers, acts, g):
    """The JAX package's ``_bwd_kernel`` (ops/fused.py) as tensor ops.

    :param acts: every layer's saved post-activation
    :param g: gradient of the output
    :return: (dx, ((dW_1, db_1), ...))
    """
    n = len(params)
    dparams = [None] * n
    for i in range(n - 1, -1, -1):
        dz = g * act_grad_from_output(acts[i], transfers[i])
        a_prev = x if i == 0 else acts[i - 1]
        dparams[i] = (a_prev.T @ dz, torch.sum(dz, 0))
        g = dz @ params[i][0].T
    return g, tuple(dparams)


def vanilla_rnn_bwd_plain(x, h, w, u, hn, g):
    """The JAX package's ``_vrnn_bwd_kernel``: (dx, dh, dW, dU, db)."""
    dz = g * (1.0 - hn * hn)
    return dz @ w.T, dz @ u.T, x.T @ dz, h.T @ dz, torch.sum(dz, 0)


def gru_bwd_plain(x, h, wg, ug, wc, uc, zr, c, g):
    """The JAX package's ``_gru_bwd_kernel``:
    (dx, dh, dWg, dUg, dbg, dWc, dUc, dbc)."""
    u_dim = h.shape[-1]
    z, r = zr[:, :u_dim], zr[:, u_dim:]
    dz = g * (c - h)
    dc_in = (g * z) * (1.0 - c * c)
    drh = dc_in @ uc.T
    dr = drh * h
    da = torch.cat([dz, dr], -1) * zr * (1.0 - zr)
    rh = r * h
    dx = dc_in @ wc.T + da @ wg.T
    dh = g * (1.0 - z) + drh * r + da @ ug.T
    return (dx, dh, x.T @ da, h.T @ da, torch.sum(da, 0), x.T @ dc_in, rh.T @ dc_in,
            torch.sum(dc_in, 0))


# ------------------------------------------------------------------ checks
def _check(name, tensors, device):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _on_cuda(name, x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _ptrs(tensors):
    """A host array of device pointers (NULL for None), passed as void*."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(name, code):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def _empty(*shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# ------------------------------------------------------ launch geometry
def _cdiv(a, b):
    return -(-a // b)


def tile_state_geometry(n):
    """The launch of a kernel whose clusters hold a tile's whole state in
    every block's shared memory, so one block an SM (the glimpse encoder's
    backward, the propagation unroll's forward and backward): 8-row tiles,
    each shared by a cluster of the largest of 1, 2, 4, 8 blocks whose
    blocks all fit the ``SMS`` SMs at once (1 where none does; 4 at 160
    rows: 80 blocks), since a cluster runs only once all its blocks have an
    SM."""
    tile_rows = 8
    tiles = _cdiv(n, tile_rows)
    cluster = max((c for c in (1, 2, 4, 8) if tiles * c <= SMS), default=1)
    return dict(tile_rows=tile_rows, cluster=cluster, blocks=tiles * cluster)


def mlp_fwd_geometry(n, dims):
    """The MLP forward kernel's launch (csrc/fused_mlp.cu), as the host
    picks it for n rows and the layer widths ``dims`` (d_in first).

    A cluster of ``cluster`` blocks shares a tile of ``tile_rows`` rows and
    splits every layer's 32-column chunks; ``cluster`` is the least of 1, 2,
    4, 8 that gives ``SMS`` blocks (8 where none does).  A round of layer l
    puts ``wk[l]`` K-blocks of 32 and 8 / wk[l] chunks on the block's 8
    warps: the split with the fewest rounds, the fewer K-blocks on a tie.
    ``smem`` is the dynamic shared memory in bytes: two stages of a round's
    weights [8][32][32] and x [8][8][36], the partial sums [8][8][32] and
    two activation buffers [8][widest hidden layer, rounded up to 32, + 4]
    (rows 4 floats past a multiple of 32, so that float4 reads of 4 rows at
    once hit other banks; none with one layer).
    """
    tile_rows, warps, block_k, chunk = 8, 8, 32, 32
    tiles = _cdiv(n, tile_rows)
    cluster = next((c for c in (1, 2, 4, 8) if tiles * c >= SMS), 8)
    wk = []
    for k, d in zip(dims[:-1], dims[1:]):
        j = _cdiv(_cdiv(d, chunk), cluster)
        nkb = _cdiv(k, block_k)
        wk.append(min((1, 2, 4, 8),
                      key=lambda w: (_cdiv(j, warps // w) * _cdiv(nkb, w), w)))
    widest = max(dims[1:-1], default=0)
    act_ld = _cdiv(widest, 32) * 32 + 4 if widest else 0
    stage = warps * block_k * chunk + warps * tile_rows * (block_k + 4)
    smem = 4 * (2 * stage + warps * tile_rows * chunk + 2 * tile_rows * act_ld)
    return dict(tile_rows=tile_rows, cluster=cluster, blocks=tiles * cluster, smem=smem,
                wk=wk)


def mlp_bwd_geometry(n, dims):
    """The launch of the MLP backward's phase A (csrc/fused_bwd.cu), as the
    host picks it for n rows and the layer widths ``dims`` (d_in first).

    A cluster of ``cluster`` blocks shares a tile of ``tile_rows`` rows and
    splits the 32-column chunks of each layer's transposed product;
    ``cluster`` is the least of 1, 2, 4, 8 that gives ``SMS`` blocks (8
    where none does), as the forward's.  ``smem`` is its dynamic shared
    memory in bytes: two stages of a round's staged W tiles [8][32][36], the
    partial sums [8][8][32] and two gradient buffers [8][widest layer output,
    rounded up to 4].  Phase B, the weight-gradient reducer, plans its own
    launch: one block per 32 x 32 tile of each dW.
    """
    tile_rows, ring, parts = 8, 2 * 8 * 32 * (32 + 4), 8 * 8 * 32
    tiles = _cdiv(n, tile_rows)
    cluster = next((c for c in (1, 2, 4, 8) if tiles * c >= SMS), 8)
    smem = 4 * (ring + parts + 2 * tile_rows * _cdiv(max(dims[1:]), 4) * 4)
    return dict(tile_rows=tile_rows, cluster=cluster, blocks=tiles * cluster, smem=smem)


LONG_K_MIN = 1024  # the least d_in of a layer the long-K kernels take
LONG_K_MAX = 10816  # the most
LONG_K_MAX_WIDTH = 512  # the widest layer they take
LONG_K_MAX_ROWS = 160  # the most rows they take
LONG_K_MAX_BLOCKS = 100  # the most blocks of a long-K forward's launch
GPC_SMS = 16  # SMs of a GPC that a cluster of blocks, one an SM, can count on


def is_long_k(n, dims):
    """Whether an MLP call of n rows and widths ``dims`` takes the long-K
    kernels (csrc/fused_mlp.cu ``fused_mlp_long_k_kernel``, csrc/fused_bwd.cu
    ``mlp_bwd_long_k_kernel``): one layer of ``LONG_K_MIN`` to
    ``LONG_K_MAX`` inputs and at most ``LONG_K_MAX_WIDTH`` outputs at 1 to
    ``LONG_K_MAX_ROWS`` rows whose forward launch (``mlp_long_k_geometry``)
    takes at most ``LONG_K_MAX_BLOCKS`` blocks: the conv model's encoders
    (10816 and 1600 -> 256 at 160 rows, 100 blocks).  There
    ``mlp_fwd_geometry``'s 8-row tiles re-read W from L2 once per 8 rows;
    the long-K kernels stage each weight tile once per 32 rows.

    The limits are those of a sweep on an H100 (PERF.md §6) at K 1024, 1600
    and 10816, widths 100, 256 and 512 and 1 to 192 rows: the long-K
    backward took 0.33-0.89 of the 8-row kernels' time at every shape, the
    forward 0.34-0.89 wherever its launch took at most 100 blocks, but up to
    1.52 at 120 and 128 blocks (clusters of 3, 4, 5 or 8, likely more than
    the card runs in one wave; ``GPC_SMS`` lets them through).  Every other
    call keeps the kernels of ``mlp_fwd_geometry`` / ``mlp_bwd_geometry``,
    tuned for short K and many calls."""
    return (len(dims) == 2 and LONG_K_MIN <= dims[0] <= LONG_K_MAX
            and dims[1] <= LONG_K_MAX_WIDTH and 1 <= n <= LONG_K_MAX_ROWS
            and mlp_long_k_geometry(n, dims)["blocks"] <= LONG_K_MAX_BLOCKS)


def mlp_long_k_geometry(n, dims):
    """The long-K forward's launch (csrc/fused_mlp.cu
    ``fused_mlp_long_k_kernel``) for n rows and one layer ``dims`` = [K, D].

    A tile of ``tile_rows`` = 32 rows by 64 columns (``col_tiles`` of them
    a row tile) belongs to a cluster of ``cluster`` blocks that split its
    K-blocks of 32 round-robin: the most, up to 8 and the K-blocks, whose
    blocks all run at once, one block an SM: at most ``SMS`` blocks, and
    clusters that fit GPCs of ``GPC_SMS`` SMs (1 where none does; 5 at 160
    rows: 100 blocks, where 6 gives 120 blocks that the card runs in two
    waves; ``is_long_k`` keeps off the launches of more than
    ``LONG_K_MAX_BLOCKS``, which this rule lets through and the card does
    not run at once).  Each block owns ``per`` of the tile's 2048 outputs (a multiple
    of 4).  ``smem`` is the dynamic shared memory in bytes: two stages of a
    round's 4 K-blocks (weights [2][32][32] and x [32][36] each) and three
    buffers of a round's partial sums, [4 cluster K-blocks][per]."""
    k, d = dims
    tiles = _cdiv(n, 32) * _cdiv(d, 64)
    nkb = _cdiv(k, 32)
    cluster = max((c for c in range(1, 9) if c <= nkb and tiles * c <= SMS
                   and tiles <= SMS // GPC_SMS * (GPC_SMS // c)), default=1)
    per = _cdiv(_cdiv(32 * 64, cluster), 4) * 4
    stage = 4 * (2 * 32 * 32 + 32 * (32 + 4))
    return dict(tile_rows=32, cluster=cluster, blocks=tiles * cluster,
                smem=4 * (2 * stage + 3 * 4 * cluster * per), col_tiles=_cdiv(d, 64), per=per)


def mlp_bwd_long_k_geometry(n, dims):
    """The launch of the long-K backward's phase A (csrc/fused_bwd.cu
    ``mlp_bwd_long_k_kernel``) for n rows and one layer ``dims`` = [K, D]:
    a block takes a tile of ``tile_rows`` = 32 rows and a run of ``steps``
    64-column steps of dx, ``col_blocks`` blocks a row tile, so that the
    (row tile, step) pairs spread evenly over ``SMS`` blocks.  ``smem`` is
    its dynamic shared memory in bytes: two stages of a round's W tiles (4
    blocks of 32 j of a step, [2][32 cols][36] each), the round's partial
    sums [4][32][66] and the tile's dz [32][D rounded up to 32, + 4].
    Phase B, the weight-gradient reducer, plans its own launch."""
    k, d = dims
    row_tiles, total = _cdiv(n, 32), _cdiv(k, 64)
    steps = _cdiv(row_tiles * total, SMS)
    col_blocks = _cdiv(total, steps)
    ldd = _cdiv(d, 32) * 32 + 4
    return dict(tile_rows=32, col_blocks=col_blocks, steps=steps, blocks=row_tiles * col_blocks,
                smem=4 * (2 * 4 * 2 * 32 * (32 + 4) + 4 * 32 * 66 + 32 * ldd))


def gru_bwd_geometry(n, d_x, units):
    """The launch of the GRU backward's phase A (csrc/fused_bwd.cu
    gru_bwd_kernel), as the host picks it for n rows, d_x inputs and
    ``units``: a cluster of ``cluster`` blocks shares a tile of
    ``tile_rows`` rows and splits the 32-column chunks of each transposed
    product (drh, dx and dh; d_x changes nothing: dx's columns are split
    like the others), ``cluster`` picked as ``mlp_bwd_geometry`` picks it
    (8 at 160 rows, 4 at 480).  ``smem`` is its dynamic shared memory in
    bytes: two stages of a round's staged W tiles [8][32][36], the partial
    sums [8][8][32] and the tile's dc_in, drh [8][units] and da [8][2
    units], widths rounded up to 4.  Phase B plans its own launch."""
    tile_rows, ring, parts = 8, 2 * 8 * 32 * (32 + 4), 8 * 8 * 32
    tiles = _cdiv(n, tile_rows)
    cluster = next((c for c in (1, 2, 4, 8) if tiles * c >= SMS), 8)
    state = tile_rows * (2 * _cdiv(units, 4) * 4 + _cdiv(2 * units, 4) * 4)
    return dict(tile_rows=tile_rows, cluster=cluster, blocks=tiles * cluster,
                smem=4 * (ring + parts + state))


def _cell_fwd_geometry(n, d_x, units, gru):
    """The launch of a cell's forward kernel (csrc/fused_rnn.cu): see
    ``vrnn_fwd_geometry`` and ``gru_fwd_geometry``."""
    tile_rows, warps, block_k, chunk = 8, 8, 32, 32
    tiles = _cdiv(n, tile_rows)
    chunks = _cdiv(units, chunk)
    splits = [c for c in (1, 2, 4, 8) if c <= chunks]
    split = next((c for c in splits if tiles * c >= SMS), splits[-1])
    per_block = _cdiv(chunks, split)
    nkb_x, nkb_h = _cdiv(d_x, block_k), _cdiv(units, block_k)
    # (chunks, K-blocks) of each stage's share of a block
    stages = ([(2 * per_block, nkb_x + nkb_h), (per_block, nkb_x), (per_block, nkb_h)] if gru
              else [(per_block, nkb_x + nkb_h)])
    wk = [min((1, 2, 4, 8), key=lambda w: (_cdiv(j, warps // w) * _cdiv(nkb, w), w))
          for j, nkb in stages]
    lda = _cdiv(d_x, block_k) * block_k + _cdiv(units, block_k) * block_k + 4
    rh_ld = _cdiv(units, block_k) * block_k + 4 if gru else 0
    zld = per_block * chunk if gru else 0
    smem = 4 * (2 * warps * block_k * chunk + warps * tile_rows * chunk
                + tile_rows * (lda + rh_ld + 2 * zld))
    return dict(tile_rows=tile_rows, split=split, blocks=tiles * split, smem=smem, wk=wk)


def vrnn_fwd_geometry(n, d_x, units):
    """The vanilla-RNN forward kernel's launch (csrc/fused_rnn.cu), as the
    host picks it.

    ``split`` blocks share a tile of ``tile_rows`` rows and split its
    32-column chunks of the output; ``split`` is the least of 1, 2, 4, 8
    (and at most the chunks) that gives ``SMS`` blocks, else the largest.
    A round puts ``wk[0]`` K-blocks of 32 of [x | h] and 8 / wk[0] chunks on
    the block's 8 warps: the split with the fewest rounds, the fewer
    K-blocks on a tie.  ``smem`` is the dynamic shared memory in bytes: two
    stages of a round's weights [8][32][32], the partial sums [8][8][32] and
    the tile's rows of [x | h] [8][d_x and U, each rounded up to 32, + 4].
    """
    return _cell_fwd_geometry(n, d_x, units, gru=False)


def gru_fwd_geometry(n, d_x, units):
    """The GRU forward kernel's launch (csrc/fused_rnn.cu), as the host
    picks it: as ``vrnn_fwd_geometry``, the ``split`` blocks of a tile
    forming one thread block cluster, with ``wk`` for each of the three
    stages (the gates' z and r chunks over [x | h], the candidate over x,
    the candidate over r h).  ``smem`` adds the cluster's r h [8][U rounded
    up to 32, + 4] and the block's z and candidate sums over x [8][its
    chunks x 32] each.
    """
    return _cell_fwd_geometry(n, d_x, units, gru=True)


def _cell_geom_ints(geom):
    return _ints([geom["tile_rows"], geom["split"], geom["blocks"], geom["smem"], *geom["wk"]])


def vrnn_bwd_geometry(n, d_x, units, need_dx=True, need_dh=True):
    """The vanilla-RNN backward kernel's launch (csrc/fused_bwd.cu), as the
    host picks it.

    ``wg_blocks`` weight-gradient blocks, one per 32 x 32 tile of [dW; dU],
    come first; then ``in_blocks`` input-gradient blocks, one per tile of
    ``rows`` batch rows x 64 columns of the [dx | dh] that is asked for.
    ``rows`` is the largest of 8, 4, 2, 1 that gives ``SMS`` blocks in all
    (1 where none does).  ``smem`` (bytes) is the larger of what the two
    kinds take: eight warps' staged [W; U] slices [64][36], dz [8][256] and
    the partial sums [8][8][64]; or the rows of [x, h] [8][32][32], the
    partial sums [8][32][32] and those of db [8][32].
    """
    warps, block_k, cols, tile_k, tile_j = 8, 32, 64, 32, 32
    c_n = (d_x if need_dx else 0) + (units if need_dh else 0)
    col_tiles = _cdiv(c_n, cols)
    wg_blocks = _cdiv(d_x + units, tile_k) * _cdiv(units, tile_j)
    rows = 8 if not col_tiles else next(
        (r for r in (8, 4, 2) if _cdiv(n, r) * col_tiles + wg_blocks >= SMS), 1)
    in_blocks = _cdiv(n, rows) * col_tiles
    smem = 4 * max(warps * cols * (block_k + 4) + 8 * warps * block_k + warps * 8 * cols,
                   warps * 32 * tile_k + warps * tile_k * tile_j + warps * tile_j)
    return dict(rows=rows, blocks=wg_blocks + in_blocks, wg_blocks=wg_blocks,
                in_blocks=in_blocks, smem=smem)


# ------------------------------------------------------------ fused_mlp
def _mlp_dims(x2, params):
    dims = [x2.shape[-1]]
    for w, b in params:
        if w.ndim != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"fused_mlp: layer shapes {tuple(w.shape)}, "
                             f"{tuple(b.shape)} after width {dims[-1]}")
        if w.shape[1] > MAX_WIDTH:
            raise ValueError(f"fused_mlp: width {w.shape[1]} > {MAX_WIDTH}")
        dims.append(w.shape[1])
    if not 1 <= len(params) <= MAX_LAYERS:
        raise ValueError(f"fused_mlp: 1 to {MAX_LAYERS} layers, got {len(params)}")
    return dims


def _mlp_fwd_cuda(x2, params, transfers, save):
    """The forward kernel on x2 [N, d_in]; every post-activation if
    ``save``, else only the output."""
    from .build import library

    dims = _mlp_dims(x2, params)
    _check("fused_mlp", [x2, *[t for wb in params for t in wb]], x2.device)
    n, n_layers = x2.shape[0], len(params)
    acts = [_empty(n, d, like=x2) if save else None for d in dims[1:-1]]
    y = _empty(n, dims[-1], like=x2)
    if n > 0 and is_long_k(n, dims):
        geom = mlp_long_k_geometry(n, dims)
        (w, b), = params
        code = library().sqair_fused_mlp_long_k(
            _ptr(x2), _ptr(y), n, dims[0], dims[1], ACTS.index(transfers[0]), _ptr(w), _ptr(b),
            _ints([geom[k] for k in ("tile_rows", "cluster", "blocks", "smem", "col_tiles",
                                     "per")]), _stream(x2.device))
        _raise_on("fused_mlp", code)
        launches["fused_mlp"] += 1
        long_k_calls["fused_mlp"] += 1
    elif n > 0:
        geom = mlp_fwd_geometry(n, dims)
        code = library().sqair_fused_mlp(
            _ptr(x2), _ptr(y), n, n_layers, _ints(dims),
            _ints([ACTS.index(t) for t in transfers]), _ptrs([w for w, _ in params]),
            _ptrs([b for _, b in params]), _ptrs(acts + [None]),
            _ints([geom["tile_rows"], geom["cluster"], geom["blocks"], geom["smem"],
                   *geom["wk"]]), _stream(x2.device))
        _raise_on("fused_mlp", code)
        launches["fused_mlp"] += 1
    return acts + [y]


def fused_mlp_bwd(x, params, transfers, acts, g, need_dx=True):
    """Backward of ``fused_mlp`` on x [N, d_in]: (dx or None,
    ((dW_1, db_1), ...)).  On CUDA the backward kernels, on the CPU
    ``mlp_bwd_plain``."""
    if not _on_cuda("fused_mlp_bwd", x):
        dx, dparams = mlp_bwd_plain(x, params, transfers, acts, g)
        return (dx if need_dx else None), dparams

    from .build import library

    dims = _mlp_dims(x, params)
    _check("fused_mlp_bwd", [x, g, *acts, *[w for w, _ in params]], x.device)
    n, n_layers = x.shape[0], len(params)
    dx = _empty(n, dims[0], like=x) if need_dx else None
    dparams = tuple((_empty(*w.shape, like=x), _empty(*b.shape, like=x)) for w, b in params)
    if n == 0:
        if dx is not None:
            dx.zero_()
        for dw, db in dparams:
            dw.zero_()
            db.zero_()
        return dx, dparams
    scratch = _empty(n * sum(dims[1:]), like=x)  # every layer's dz, [N, d_i] each
    dz, off = [], 0
    for d in dims[1:]:
        dz.append(scratch[off:off + n * d])
        off += n * d
    long_k = is_long_k(n, dims)
    if long_k:
        geom = mlp_bwd_long_k_geometry(n, dims)
        (w, _), = params
        (dw, db), = dparams
        code = library().sqair_fused_mlp_bwd_long_k(
            _ptr(x), _ptr(g), _ptr(dx), n, dims[0], dims[1], ACTS.index(transfers[0]), _ptr(w),
            _ptr(acts[0]), _ptr(dz[0]), _ptr(dw), _ptr(db),
            _ints([geom[k] for k in ("tile_rows", "col_blocks", "steps", "blocks", "smem")]),
            _stream(x.device))
    else:
        geom = mlp_bwd_geometry(n, dims)
        code = library().sqair_fused_mlp_bwd(
            _ptr(x), _ptr(g), _ptr(dx), n, n_layers, _ints(dims),
            _ints([ACTS.index(t) for t in transfers]), _ptrs([w for w, _ in params]),
            _ptrs(list(acts)), _ptrs(dz), _ptrs([dw for dw, _ in dparams]),
            _ptrs([db for _, db in dparams]),
            _ints([geom[k] for k in ("tile_rows", "cluster", "blocks", "smem")]),
            _stream(x.device))
    _raise_on("fused_mlp_bwd", code)
    launches["fused_mlp_bwd"] += 1
    if long_k:
        long_k_calls["fused_mlp_bwd"] += 1
    return dx, dparams


class _MLPFunction(torch.autograd.Function):
    """fused_mlp with its backward kernel; saves x, the params and every
    post-activation, as the JAX package's ``_fused_fwd``."""

    @staticmethod
    def forward(ctx, x2, transfers, *flat):
        params = tuple(zip(flat[0::2], flat[1::2]))
        if x2.device.type == "cuda":
            acts = _mlp_fwd_cuda(x2, params, transfers, save=True)
        else:
            acts = mlp_plain_acts(x2, params, transfers)
        ctx.transfers = transfers
        ctx.save_for_backward(x2, *flat, *acts)
        return acts[-1]

    @staticmethod
    def backward(ctx, g):
        n = len(ctx.transfers)
        saved = ctx.saved_tensors
        x2, flat, acts = saved[0], saved[1:1 + 2 * n], saved[1 + 2 * n:]
        params = tuple(zip(flat[0::2], flat[1::2]))
        dx, dparams = fused_mlp_bwd(x2, params, ctx.transfers, acts, g.contiguous(),
                                    need_dx=ctx.needs_input_grad[0])
        return (dx, None, *[t for dwb in dparams for t in dwb])


def fused_mlp(x: torch.Tensor, params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              transfers: Sequence[str]) -> torch.Tensor:
    """Runs an MLP stack as one kernel.

    :param x: [..., d_in] (leading dims are flattened for the kernel)
    :param params: ((W [d_i, d_{i+1}], b [d_{i+1}]), ...)
    :param transfers: activation per layer, from ``ACTS``
    """
    transfers = tuple(transfers)
    if len(transfers) != len(params):
        raise ValueError("one transfer per layer")
    for t in transfers:
        if t not in ACTS:
            raise ValueError(f"unknown transfer '{t}'")
    flat = [t for wb in params for t in wb]
    cuda = _on_cuda("fused_mlp", x)
    if not cuda and not _needs_grad(x, *flat):
        return mlp_plain(x, params, transfers)
    lead, d_out = x.shape[:-1], params[-1][0].shape[-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _needs_grad(x2, *flat):
        y = _MLPFunction.apply(x2, transfers, *flat)
    else:
        y = _mlp_fwd_cuda(x2, params, transfers, save=False)[-1]
    return y.reshape(*lead, d_out)


# -------------------------------------------------------------- RNN cells
def _check_cell(name, x, h, mats):
    if x.ndim != 2 or h.ndim != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and h {tuple(h.shape)}")
    for t, shape in mats:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")


def _vrnn_fwd_cuda(x, h, w, u, b):
    from .build import library

    n, dx = x.shape
    units = h.shape[-1]
    _check_cell("fused_vanilla_rnn", x, h,
                [(w, (dx, units)), (u, (units, units)), (b, (units,))])
    if units > MAX_WIDTH:
        raise ValueError(f"fused_vanilla_rnn: {units} units > {MAX_WIDTH}")
    _check("fused_vanilla_rnn", [x, h, w, u, b], x.device)
    hn = _empty(n, units, like=x)
    if n > 0:
        code = library().sqair_fused_vanilla_rnn(
            _ptr(x), _ptr(h), _ptr(w), _ptr(u), _ptr(b), _ptr(hn), n, dx, units,
            _cell_geom_ints(vrnn_fwd_geometry(n, dx, units)), _stream(x.device))
        _raise_on("fused_vanilla_rnn", code)
        launches["fused_vanilla_rnn"] += 1
    return hn


def fused_vanilla_rnn_bwd(x, h, w, u, hn, g, need_dx=True, need_dh=True):
    """Backward of ``fused_vanilla_rnn``: (dx, dh, dW, dU, db), dx and dh
    None where not needed.  On CUDA the backward kernels, on the CPU
    ``vanilla_rnn_bwd_plain``."""
    if not _on_cuda("fused_vanilla_rnn_bwd", x):
        dx, dh, dw, du, db = vanilla_rnn_bwd_plain(x, h, w, u, hn, g)
        return (dx if need_dx else None), (dh if need_dh else None), dw, du, db

    from .build import library

    n, d_x = x.shape
    units = h.shape[-1]
    _check_cell("fused_vanilla_rnn_bwd", x, h,
                [(w, (d_x, units)), (u, (units, units)), (hn, (n, units)), (g, (n, units))])
    _check("fused_vanilla_rnn_bwd", [x, h, w, u, hn, g], x.device)
    dx = _empty(n, d_x, like=x) if need_dx else None
    dh = _empty(n, units, like=x) if need_dh else None
    dw, du, db = _empty(d_x, units, like=x), _empty(units, units, like=x), _empty(units, like=x)
    if n == 0:
        for t in (dx, dh, dw, du, db):
            if t is not None:
                t.zero_()
        return dx, dh, dw, du, db
    geom = vrnn_bwd_geometry(n, d_x, units, need_dx, need_dh)
    code = library().sqair_fused_vanilla_rnn_bwd(
        _ptr(x), _ptr(h), _ptr(w), _ptr(u), _ptr(hn), _ptr(g), _ptr(dx), _ptr(dh),
        _ptr(dw), _ptr(du), _ptr(db), n, d_x, units,
        _ints([geom["rows"], geom["blocks"], geom["smem"]]), _stream(x.device))
    _raise_on("fused_vanilla_rnn_bwd", code)
    launches["fused_vanilla_rnn_bwd"] += 1
    return dx, dh, dw, du, db


class _VanillaRNNFunction(torch.autograd.Function):
    """fused_vanilla_rnn with its backward kernel; saves x, h, W, U and h'
    as the JAX package's ``_fused_vrnn_fwd``."""

    @staticmethod
    def forward(ctx, x, h, w, u, b):
        if x.device.type == "cuda":
            hn = _vrnn_fwd_cuda(x, h, w, u, b)
        else:
            hn = vanilla_rnn_plain(x, h, w, u, b)
        ctx.save_for_backward(x, h, w, u, hn)
        return hn

    @staticmethod
    def backward(ctx, g):
        x, h, w, u, hn = ctx.saved_tensors
        return fused_vanilla_rnn_bwd(x, h, w, u, hn, g.contiguous(),
                                     need_dx=ctx.needs_input_grad[0],
                                     need_dh=ctx.needs_input_grad[1])


def fused_vanilla_rnn(x, h, w, u, b):
    """h' = tanh(x W + h U + b) as one kernel.  x [N, d_x], h [N, U]."""
    if _needs_grad(x, h, w, u, b):
        return _VanillaRNNFunction.apply(x, h, w, u, b)
    if not _on_cuda("fused_vanilla_rnn", x):
        return vanilla_rnn_plain(x, h, w, u, b)
    return _vrnn_fwd_cuda(x, h, w, u, b)


def _gru_fwd_cuda(x, h, wg, ug, bg, wc, uc, bc, save):
    """(h', zr, c) with the forward kernel; zr and c are None unless ``save``."""
    from .build import library

    n, dx = x.shape
    units = h.shape[-1]
    _check_cell("fused_gru", x, h,
                [(wg, (dx, 2 * units)), (ug, (units, 2 * units)),
                 (bg, (2 * units,)), (wc, (dx, units)), (uc, (units, units)),
                 (bc, (units,))])
    if 2 * units > MAX_WIDTH:
        raise ValueError(f"fused_gru: {units} units > {MAX_WIDTH // 2}")
    _check("fused_gru", [x, h, wg, ug, bg, wc, uc, bc], x.device)
    hn = _empty(n, units, like=x)
    zr = _empty(n, 2 * units, like=x) if save else None
    c = _empty(n, units, like=x) if save else None
    if n > 0:
        code = library().sqair_fused_gru(
            _ptr(x), _ptr(h), _ptr(wg), _ptr(ug), _ptr(bg), _ptr(wc), _ptr(uc),
            _ptr(bc), _ptr(hn), _ptr(zr), _ptr(c), n, dx, units,
            _cell_geom_ints(gru_fwd_geometry(n, dx, units)), _stream(x.device))
        _raise_on("fused_gru", code)
        launches["fused_gru"] += 1
    return hn, zr, c


def fused_gru_bwd(x, h, wg, ug, wc, uc, zr, c, g, need_dx=True, need_dh=True):
    """Backward of ``fused_gru``: (dx, dh, dWg, dUg, dbg, dWc, dUc, dbc), dx
    and dh None where not needed.  On CUDA the backward kernels, on the CPU
    ``gru_bwd_plain``."""
    if not _on_cuda("fused_gru_bwd", x):
        dx, dh, *rest = gru_bwd_plain(x, h, wg, ug, wc, uc, zr, c, g)
        return ((dx if need_dx else None), (dh if need_dh else None), *rest)

    from .build import library

    n, d_x = x.shape
    units = h.shape[-1]
    _check_cell("fused_gru_bwd", x, h,
                [(wg, (d_x, 2 * units)), (ug, (units, 2 * units)), (wc, (d_x, units)),
                 (uc, (units, units)), (zr, (n, 2 * units)), (c, (n, units)),
                 (g, (n, units))])
    _check("fused_gru_bwd", [x, h, wg, ug, wc, uc, zr, c, g], x.device)
    dx = _empty(n, d_x, like=x) if need_dx else None
    dh = _empty(n, units, like=x) if need_dh else None
    grads = [_empty(*t.shape, like=x) for t in (wg, ug)] + [_empty(2 * units, like=x)]
    grads += [_empty(*t.shape, like=x) for t in (wc, uc)] + [_empty(units, like=x)]
    if n == 0:
        for t in [dx, dh, *grads]:
            if t is not None:
                t.zero_()
        return (dx, dh, *grads)
    dc_in, da, rh = _empty(n, units, like=x), _empty(n, 2 * units, like=x), \
        _empty(n, units, like=x)
    geom = gru_bwd_geometry(n, d_x, units)
    code = library().sqair_fused_gru_bwd(
        _ptr(x), _ptr(h), _ptr(wg), _ptr(ug), _ptr(wc), _ptr(uc), _ptr(zr), _ptr(c),
        _ptr(g), _ptr(dc_in), _ptr(da), _ptr(rh), _ptr(dx), _ptr(dh),
        *[_ptr(t) for t in grads], n, d_x, units,
        _ints([geom[k] for k in ("tile_rows", "cluster", "blocks", "smem")]),
        _stream(x.device))
    _raise_on("fused_gru_bwd", code)
    launches["fused_gru_bwd"] += 1
    return (dx, dh, *grads)


class _GRUFunction(torch.autograd.Function):
    """fused_gru with its backward kernel; saves x, h, Wg, Ug, Wc, Uc, zr and
    c, as the JAX package's ``_fused_gru_fwd``."""

    @staticmethod
    def forward(ctx, x, h, wg, ug, bg, wc, uc, bc):
        if x.device.type == "cuda":
            hn, zr, c = _gru_fwd_cuda(x, h, wg, ug, bg, wc, uc, bc, save=True)
        else:
            hn, zr, c = gru_plain_saving(x, h, wg, ug, bg, wc, uc, bc)
        ctx.save_for_backward(x, h, wg, ug, wc, uc, zr, c)
        return hn

    @staticmethod
    def backward(ctx, g):
        dx, dh, dwg, dug, dbg, dwc, duc, dbc = fused_gru_bwd(
            *ctx.saved_tensors, g.contiguous(), need_dx=ctx.needs_input_grad[0],
            need_dh=ctx.needs_input_grad[1])
        return dx, dh, dwg, dug, dbg, dwc, duc, dbc


def fused_gru(x, h, wg, ug, bg, wc, uc, bc):
    """One GRU step as one kernel.  x [N, d_x], h [N, U]."""
    if _needs_grad(x, h, wg, ug, bg, wc, uc, bc):
        return _GRUFunction.apply(x, h, wg, ug, bg, wc, uc, bc)
    if not _on_cuda("fused_gru", x):
        return gru_plain(x, h, wg, ug, bg, wc, uc, bc)
    return _gru_fwd_cuda(x, h, wg, ug, bg, wc, uc, bc, save=False)[0]
