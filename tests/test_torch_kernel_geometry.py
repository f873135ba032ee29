"""The host's launch geometry of the kernels redesigned for Hopper
(``ops/fused.py``: ``mlp_fwd_geometry`` for csrc/fused_mlp.cu,
``vrnn_fwd_geometry`` and ``gru_fwd_geometry`` for the cells' forwards of
csrc/fused_rnn.cu, ``vrnn_bwd_geometry``, ``mlp_bwd_geometry`` and
``gru_bwd_geometry`` for the vanilla-RNN, MLP and GRU backwards of
csrc/fused_bwd.cu; ``ops/fused_cells.py``: ``prop_fwd_geometry`` and
``prop_bwd_geometry`` for the propagation forward and backward of
csrc/fused_prop.cu, ``disc_fwd_geometry`` and ``disc_bwd_geometry`` for the
discovery forward and backward of csrc/fused_disc.cu; ``ops/fused_glimpse.py``:
``glimpse_fwd_geometry`` and ``glimpse_bwd_geometry`` for the glimpse
forward and backward of csrc/fused_glimpse.cu), at every MLP, vanilla-RNN,
GRU, glimpse, propagation and discovery shape of
``chip_smoke.main_path_shapes``: the release flags, with no switch and with
both switches, eval and train (and the propagation and discovery unrolls
at DISC_FLAGS).

The MLP shapes are also walked at the conv configuration
(``chip_smoke.conv_flags``), whose one-layer encoders of long K (10816 and
1600 -> 256 at 160 rows) take the long-K kernels (``fused.is_long_k``,
``mlp_long_k_geometry``, ``mlp_bwd_long_k_geometry``) and no other call
does.

Each launch fills the card's 132 SMs wherever n allows it, takes a cluster
(or column split) of 1-8 blocks and at most the 227 KB of shared memory a
block may have; the wrappers pass that geometry to the C entry.  Runs on
the CPU (no card).
"""
import ctypes
import json
import math
import sys
from pathlib import Path

import pytest
import torch

from sqair_tpu_torch.ops import build, fused
from sqair_tpu_torch.ops import fused_cells as fc
from sqair_tpu_torch.ops import fused_glimpse as fg

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

# (configuration, train, fuse): the release flags on 50x50 frames and the
# pedestrian configuration on 64x48 frames with 32x12 glimpses
SETTINGS = [pytest.param(config, train, fuse,
                         id=("" if config == "release" else config + "-") + f"{train}-{fuse}")
            for config in ("release", "pedestrian") for train in (False, True)
            for fuse in (False, True)]
PED_IMG = (64, 48)
# the conv configuration, whose two switches fuse nothing
CONV_SETTINGS = [pytest.param("conv", train, False, id=f"conv-{train}")
                 for train in (False, True)]


def _config(config, disc=False):
    """(flags, B, k, T, img) of a configuration; ``disc``: with DISC_LEVERS."""
    if config == "release":
        flags = json.loads(chip_smoke.RELEASE_FLAGS.read_text())
        T, img = int(flags.get("font_timesteps", 10)), chip_smoke.IMG
    elif config == "conv":
        flags, T, img = chip_smoke.conv_flags(), 10, chip_smoke.IMG
    else:
        flags = chip_smoke.ped_flags()
        T, img = int(flags["ped_timesteps"]), PED_IMG
        assert tuple(int(v) for v in flags["ped_canvas"].split(",")) == img
    if disc:
        flags = dict(flags, **chip_smoke.DISC_LEVERS)
    return flags, int(flags["batch_size"]), int(flags["k_particles"]), T, img


def _shapes(kernel, config, train, fuse, disc=False):
    flags, B, k, T, img = _config(config, disc)
    shapes = chip_smoke.main_path_shapes(flags, B, k, T, train=train, img=img,
                                         fuse_glimpse=fuse, fuse_cells=fuse)
    return [s for kn, s, _ in shapes if kn == kernel]


def _check_long_k_geometry(n, dims):
    """The long-K launches of n rows of the one layer ``dims``: the forward's
    clusters split K over the most blocks (up to 8) that run at once, one
    block an SM, in GPCs of ``GPC_SMS``; its owners cover the tile's 2048
    outputs; the backward's blocks cover every (row tile, 64-column step)
    pair, one an SM."""
    k, d = dims
    g = fused.mlp_long_k_geometry(n, dims)
    tiles = math.ceil(n / 32) * math.ceil(d / 64)
    nkb = math.ceil(k / 32)

    def fits(c):
        return (c <= nkb and tiles * c <= fused.SMS
                and tiles <= fused.SMS // fused.GPC_SMS * (fused.GPC_SMS // c))
    assert g["tile_rows"] == 32 and g["col_tiles"] == math.ceil(d / 64), (n, dims, g)
    assert g["blocks"] == tiles * g["cluster"], (n, dims, g)
    assert fits(g["cluster"]) or g["cluster"] == 1, (n, dims, g)
    assert g["cluster"] == 8 or not fits(g["cluster"] + 1), (n, dims, g)
    assert g["per"] % 4 == 0 and g["per"] * (g["cluster"] - 1) < 2048 <= g["per"] * g["cluster"]
    assert g["smem"] <= fused.MAX_SMEM, (n, dims, g)
    b = fused.mlp_bwd_long_k_geometry(n, dims)
    row_tiles, steps = math.ceil(n / 32), math.ceil(k / 64)
    assert b["tile_rows"] == 32 and b["blocks"] == row_tiles * b["col_blocks"], (n, dims, b)
    assert (b["col_blocks"] - 1) * b["steps"] < steps <= b["col_blocks"] * b["steps"], (n, b)
    assert b["blocks"] <= fused.SMS or b["steps"] > 1, (n, dims, b)
    assert b["steps"] == math.ceil(row_tiles * steps / fused.SMS), (n, dims, b)
    assert b["smem"] <= fused.MAX_SMEM, (n, dims, b)
    return g, b


@pytest.mark.parametrize("config,train,fuse", SETTINGS + CONV_SETTINGS)
def test_mlp_forward_geometry_fills_the_card(config, train, fuse):
    shapes = _shapes("fused_mlp", config, train, fuse)
    assert shapes
    for s in shapes:
        dims = [s["d_in"]] + s["widths"]
        if fused.is_long_k(s["n"], dims):
            g, _ = _check_long_k_geometry(s["n"], dims)
            if s["n"] == 160:  # 20 tiles of 32 x 64: 5 blocks each, 100 in all
                assert g["cluster"] == 5 and g["blocks"] == 100, (s, g)
            continue
        g = fused.mlp_fwd_geometry(s["n"], dims)
        tiles = math.ceil(s["n"] / g["tile_rows"])
        assert 1 <= g["cluster"] <= 8, (s, g)
        assert g["blocks"] == tiles * g["cluster"], (s, g)
        # 8 blocks a row tile is the most a cluster gives
        assert g["blocks"] >= min(fused.SMS, tiles * 8), (s, g)
        assert g["smem"] <= fused.MAX_SMEM, (s, g)
        assert len(g["wk"]) == len(s["widths"]) and set(g["wk"]) <= {1, 2, 4, 8}, (s, g)
        if s["n"] == 160:
            assert g["cluster"] == 8 and g["blocks"] >= fused.SMS, (s, g)


@pytest.mark.parametrize("config,train,fuse", SETTINGS + CONV_SETTINGS)
def test_vrnn_backward_geometry_fills_the_card(config, train, fuse):
    shapes = _shapes("fused_vanilla_rnn", config, train, fuse)
    assert shapes
    for s in shapes:
        n, d_x, units = s["n"], s["dx"], s["units"]
        g = fused.vrnn_bwd_geometry(n, d_x, units, need_dx=True, need_dh=True)
        col_tiles = math.ceil((d_x + units) / 64)
        assert g["rows"] in (1, 2, 4, 8), (s, g)
        assert g["in_blocks"] == math.ceil(n / g["rows"]) * col_tiles, (s, g)
        assert g["wg_blocks"] == math.ceil((d_x + units) / 32) * math.ceil(units / 32), (s, g)
        assert g["blocks"] == g["in_blocks"] + g["wg_blocks"], (s, g)
        # one batch row a tile is the most the input-gradient blocks give
        assert g["blocks"] >= min(fused.SMS, n * col_tiles + g["wg_blocks"]), (s, g)
        assert g["blocks"] >= fused.SMS, (s, g)  # every main-path shape fills the card
        assert g["smem"] <= fused.MAX_SMEM, (s, g)


@pytest.mark.parametrize("need_dx,need_dh", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_vrnn_backward_geometry_covers_the_asked_gradients(need_dx, need_dh):
    """The input-gradient blocks cover only the [dx | dh] columns asked for,
    and none are launched when neither is."""
    g = fused.vrnn_bwd_geometry(160, 567, 256, need_dx, need_dh)
    cols = (567 if need_dx else 0) + (256 if need_dh else 0)
    assert g["in_blocks"] == math.ceil(160 / g["rows"]) * math.ceil(cols / 64)
    assert g["wg_blocks"] == math.ceil((567 + 256) / 32) * 256 // 32
    assert (g["in_blocks"] == 0) == (cols == 0)


def test_mlp_forward_geometry_keeps_a_k_block_chain_per_warp_round():
    """Every layer's split puts 8 units on the 8 warps (wk K-blocks of 8 / wk
    chunks) and takes the fewest rounds, the fewer K-blocks on a tie."""
    for n, dims in [(160, [2500, 256, 256]), (4800, [50, 256, 256, 400]), (1, [1, 10, 4]),
                    (13, [2500, 1, 1024, 400, 1024])]:
        g = fused.mlp_fwd_geometry(n, dims)
        for (k, d), wk in zip(zip(dims[:-1], dims[1:]), g["wk"]):
            j = math.ceil(math.ceil(d / 32) / g["cluster"])
            rounds = {w: math.ceil(j / (8 // w)) * math.ceil(k / 32 / w) for w in (1, 2, 4, 8)}
            assert rounds[wk] == min(rounds.values())
            assert wk == min(w for w in rounds if rounds[w] == rounds[wk])
    assert fused.mlp_fwd_geometry(160, [2500, 256, 256])["wk"] == [8, 8]
    assert fused.mlp_fwd_geometry(4800, [50, 256, 256, 400])["cluster"] == 1


@pytest.fixture
def seen(monkeypatch):
    """The C entries' arguments, from a stand-in library that records them."""
    calls = {}

    class FakeLibrary:
        def __getattr__(self, name):
            argtypes = build.PROTOTYPES[name]

            def call(*args):
                assert len(args) == len(argtypes), (name, len(args), len(argtypes))
                for a, t in zip(args, argtypes):
                    t.from_param(a)
                calls[name] = args
                return 0
            return call

    monkeypatch.setattr(build, "library", lambda: FakeLibrary())
    monkeypatch.setattr(fused, "_stream", lambda device: ctypes.c_void_p(0))
    return calls


def test_wrappers_pass_the_geometry_to_the_c_entries(seen, monkeypatch):
    """The forward MLP and the vanilla-RNN backward hand the host's geometry
    to their C entries (the library is a stand-in that records it)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(160, 54, generator=gen)
    params = [(torch.rand(54, 256, generator=gen), torch.rand(256, generator=gen)),
              (torch.rand(256, 4, generator=gen), torch.rand(4, generator=gen))]
    fused._mlp_fwd_cuda(x, params, ("elu", "id"), save=True)
    g = fused.mlp_fwd_geometry(160, [54, 256, 4])
    assert list(seen["sqair_fused_mlp"][9]) == [g["tile_rows"], g["cluster"], g["blocks"],
                                                 g["smem"], *g["wk"]]
    monkeypatch.setattr(fused, "_on_cuda", lambda name, t: True)
    h, w, u = torch.rand(160, 4), torch.rand(4, 4), torch.rand(4, 4)
    xv = torch.rand(160, 4)
    fused.fused_vanilla_rnn_bwd(xv, h, w, u, h, h, need_dx=False)
    g = fused.vrnn_bwd_geometry(160, 4, 4, need_dx=False, need_dh=True)
    assert list(seen["sqair_fused_vanilla_rnn_bwd"][14]) == [g["rows"], g["blocks"], g["smem"]]
    assert seen["sqair_fused_vanilla_rnn_bwd"][6].value is None  # no dx


CELL_GEOMETRY = {"fused_vanilla_rnn": fused.vrnn_fwd_geometry,
                 "fused_gru": fused.gru_fwd_geometry}


@pytest.mark.parametrize("kernel", sorted(CELL_GEOMETRY))
@pytest.mark.parametrize("config,train,fuse", SETTINGS + CONV_SETTINGS)
def test_cell_forward_geometry_fills_the_card(kernel, config, train, fuse):
    shapes = _shapes(kernel, config, train, fuse)
    assert shapes
    for s in shapes:
        n, d_x, units = s["n"], s["dx"], s["units"]
        g = CELL_GEOMETRY[kernel](n, d_x, units)
        tiles, chunks = math.ceil(n / 8), math.ceil(units / 32)
        assert g["tile_rows"] == 8, (s, g)
        assert 1 <= g["split"] <= min(8, chunks), (s, g)
        assert g["blocks"] == tiles * g["split"], (s, g)
        # the widest split the output's 32-column chunks allow
        widest = max(c for c in (1, 2, 4, 8) if c <= chunks)
        assert g["blocks"] >= min(fused.SMS, tiles * widest), (s, g)
        if units == 256:  # every full-width cell of the main path fills the card
            assert g["blocks"] >= fused.SMS, (s, g)
        assert g["smem"] <= fused.MAX_SMEM, (s, g)
        assert len(g["wk"]) == (3 if kernel == "fused_gru" else 1), (s, g)
        assert set(g["wk"]) <= {1, 2, 4, 8}, (s, g)


def test_cell_forward_geometry_splits_and_rounds():
    """8 blocks a tile at 160 rows, 4 at 480, 1 at 1600 or for a 4-unit cell;
    each stage's split takes the fewest rounds, the fewer K-blocks on a tie."""
    assert fused.vrnn_fwd_geometry(160, 567, 256)["split"] == 8
    assert fused.gru_fwd_geometry(160, 360, 256)["split"] == 8
    assert fused.gru_fwd_geometry(480, 54, 256)["split"] == 4
    assert fused.vrnn_fwd_geometry(1600, 567, 256)["split"] == 1
    assert fused.vrnn_fwd_geometry(1600, 4, 4)["split"] == 1
    assert fused.vrnn_fwd_geometry(160, 4, 4)["split"] == 1
    for n, d_x, units in [(160, 567, 256), (480, 54, 256), (1600, 4, 4), (13, 0, 96),
                          (161, 31, 512)]:
        for kernel, geometry in CELL_GEOMETRY.items():
            if kernel == "fused_gru" and units > 512:
                continue
            g = geometry(n, d_x, units)
            j = math.ceil(math.ceil(units / 32) / g["split"])
            nkb_x, nkb_h = math.ceil(d_x / 32), math.ceil(units / 32)
            stages = ([(2 * j, nkb_x + nkb_h), (j, nkb_x), (j, nkb_h)]
                      if kernel == "fused_gru" else [(j, nkb_x + nkb_h)])
            for (chunks, nkb), wk in zip(stages, g["wk"]):
                rounds = {w: math.ceil(chunks / (8 // w)) * math.ceil(nkb / w)
                          for w in (1, 2, 4, 8)}
                assert rounds[wk] == min(rounds.values()), (n, d_x, units, kernel)
                assert wk == min(w for w in rounds if rounds[w] == rounds[wk])


@pytest.mark.parametrize("save", (False, True))
def test_cell_wrappers_pass_the_geometry_to_the_c_entries(seen, save):
    """The vanilla-RNN and GRU forwards hand the host's geometry to their C
    entries, the GRU its zr and c pointers only when it saves them."""
    gen = torch.Generator().manual_seed(0)
    n, d_x, units = 160, 567, 256
    x, h = torch.rand(n, d_x, generator=gen), torch.rand(n, units, generator=gen)
    fused._vrnn_fwd_cuda(x, h, torch.rand(d_x, units), torch.rand(units, units),
                         torch.rand(units))
    g = fused.vrnn_fwd_geometry(n, d_x, units)
    assert list(seen["sqair_fused_vanilla_rnn"][9]) == [g["tile_rows"], g["split"],
                                                        g["blocks"], g["smem"], *g["wk"]]
    n, d_x = 480, 54
    x, h = torch.rand(n, d_x, generator=gen), torch.rand(n, units, generator=gen)
    hn, zr, c = fused._gru_fwd_cuda(
        x, h, torch.rand(d_x, 2 * units), torch.rand(units, 2 * units),
        torch.rand(2 * units), torch.rand(d_x, units), torch.rand(units, units),
        torch.rand(units), save=save)
    g = fused.gru_fwd_geometry(n, d_x, units)
    args = seen["sqair_fused_gru"]
    assert list(args[14]) == [g["tile_rows"], g["split"], g["blocks"], g["smem"], *g["wk"]]
    assert (args[9].value is not None) == save and (args[10].value is not None) == save
    assert (zr is not None) == save and (c is not None) == save


@pytest.mark.parametrize("config,train,fuse", SETTINGS + CONV_SETTINGS)
def test_mlp_backward_geometry_fills_the_card(config, train, fuse):
    """Phase A: clusters of 1-8 blocks over 8-row tiles, the forward's rule
    (160 blocks at 160 rows), two blocks an SM in shared memory; at the
    conv encoders' long K, blocks of 32 rows over runs of dx's 64-column
    steps (125 blocks at 160 rows)."""
    shapes = _shapes("fused_mlp", config, train, fuse)
    assert shapes
    for s in shapes:
        dims = [s["d_in"]] + s["widths"]
        if fused.is_long_k(s["n"], dims):
            _, b = _check_long_k_geometry(s["n"], dims)
            if s["n"] == 160:
                assert b["blocks"] == 125, (s, b)
            continue
        g = fused.mlp_bwd_geometry(s["n"], dims)
        tiles = math.ceil(s["n"] / 8)
        assert g["tile_rows"] == 8 and 1 <= g["cluster"] <= 8, (s, g)
        assert g["cluster"] == fused.mlp_fwd_geometry(s["n"], dims)["cluster"], (s, g)
        assert g["blocks"] == tiles * g["cluster"], (s, g)
        assert g["blocks"] >= min(fused.SMS, tiles * 8), (s, g)
        if s["n"] == 160:
            assert g["cluster"] == 8 and g["blocks"] >= fused.SMS, (s, g)
        assert 2 * g["smem"] <= fused.MAX_SMEM, (s, g)  # two blocks an SM


def _r4(v):
    return -(-v // 4) * 4


_RING, _PARTS = 2 * 8 * 32 * (32 + 4), 8 * 8 * 32  # cluster_dense.cuh kRingT, kParts


def _sparse_crop_floats(H, W, gh, gw, bwd):
    """glimpse_common.cuh SparseCrop::floats: one row's two-non-zero crop."""
    n, a = gh + gw, H * gw
    return 4 * n + a + ((a + 3 * n + 2 * H) if bwd else 0)


def _glimpse_bwd_smem(dims, masked):
    """Bytes of the glimpse backward's shared memory, as csrc/fused_glimpse.cu
    bwd_smem lays it out for the kernel dims [n, H, W, gh, gw, d_mi, d_m, d1,
    d2, n_what] (a copy, as ``_prop_bwd_smem``): the tile's row gradients
    dhp, dz2, dz1, (masked) dmz2, dmz1, and the crop rows' glimpse gradient,
    [8][width rounded up to 4] each, then the products' ring (which the
    crops borrow) and their partial sums."""
    _, H, W, gh, gw, _, d_m, d1, d2, nw = dims
    G = gh * gw
    widths = [2 * nw, d2, d1] + ([G, d_m] if masked else []) + [G]
    ring = max(_RING, _r4(_sparse_crop_floats(H, W, gh, gw, True)))
    return 4 * (sum(8 * _r4(w) for w in widths) + ring + _PARTS)


def _prop_fwd_smem(dims):
    """Bytes of the propagation forward's shared memory, as csrc/fused_prop.cu
    fwd_smem lays it out for the kernel dims (a copy, as ``_prop_bwd_smem``):
    the state that lives across a slot (rin, stp, tin, spf, the where-bias
    location, the mask), the largest region a phase of a slot lays out (the
    estimator's st8 past the glimpse's gbuf; the heads after the GRU's
    htn), the ring and the partial sums; [8][width rounded up to 4] each."""
    _, _, H, W, gh, gw, nw, U, SP, WB, MH = dims
    G = gh * gw
    d_rnn, d_stp, d_tin, d_spf = 3 * nw + 10 + U, 2 * U + 4, U + 4 + 2 * nw, 2 * U + nw
    live = sum(8 * _r4(w) for w in (d_rnn, d_stp, d_tin, d_spf, 4, G))
    glimpse = [G, U, U, 2 * nw]
    phases = [[WB, MH], glimpse, [U, U], [U, 2 * U, U, U], [U, 2 * nw, 3 * nw, SP]]
    region = max(sum(8 * _r4(w) for w in ph) for ph in phases)
    region = max(region, max(8 * 2 * _r4(U), 8 * _r4(G)) + 8 * 8)  # st8
    ring = max(_RING, _r4(_sparse_crop_floats(H, W, gh, gw, False)))
    return 4 * (live + region + ring + _PARTS)


def _prop_bwd_smem(dims):
    """Bytes of the propagation backward's shared memory, as csrc/fused_prop.cu
    bwd_smem lays it out for the kernel dims (the C entry works them out
    itself; this copy lets the CPU check that one block fits an SM): the
    state that lives across a slot, the largest region a phase of a slot
    lays out, the products' ring (which a crop borrows) and their partial
    sums, each array rounded up to 4 floats."""
    B, S, H, W, gh, gw, nw, U, SP, WB, MH = dims
    G, d_rnn = gh * gw, 3 * nw + 10 + U
    d_tin, d_spf = U + 4 + 2 * nw, 2 * U + nw
    n = 8

    def r4(v):
        return -(-v // 4) * 4

    lu, l2u, lg, lhp = r4(U), r4(2 * U), r4(G), r4(2 * nw)
    live = sum(r4(n * w) for w in (U, nw, 4, 1, U, 1, 1, d_spf, nw, 4, 2 * nw, d_tin, G, 4))
    phases = ([r4(SP)], [r4(3 * nw), r4(2 * nw), lu, lu, lu, l2u], [lhp, lu, lu, lg],
              [8, lu, lu], [max(lu, lhp), r4(d_rnn)], [4, r4(WB)], [lg, r4(MH)])
    region = max(sum(r4(n * w) for w in ph) for ph in phases)
    crop = (H * W + gh * H + gw * W + H * gw + gh + gw) + (H * gw + gh * H + gw * W + gh + gw) + G
    ring = r4(max(2 * 8 * 32 * (32 + 4), crop))
    return 4 * (live + region + ring + 8 * 8 * 32)


def _prop_kernel_dims(flags, n, img=chip_smoke.IMG):
    shape = chip_smoke.prop_shape(flags, n, img)
    return [n, shape["S"], *shape["img"], *shape["glimpse"], shape["n_what"], shape["U"],
            shape["SP"], shape["WB"], shape["MH"]]


@pytest.mark.parametrize("disc", (False, True))
@pytest.mark.parametrize("config,train,fuse", SETTINGS)
def test_prop_backward_geometry_fills_the_card(config, train, fuse, disc):
    """One block an SM (the tile's whole backward state in shared memory),
    clusters of 1-8 blocks over 8-row tiles: the widest cluster whose blocks
    all fit the card at once (4 at 160 rows: 80 blocks), at the main path's
    propagation shape with both switches (release flags and DISC_FLAGS) and
    at tile edges."""
    flags, _, _, _, img = _config(config, disc)
    prop = [s["n"] for s in _shapes("fused_prop", config, train, fuse, disc)]
    assert bool(prop) == fuse
    for n in prop + [1, 3, 8, 9, 161]:
        g = fc.prop_bwd_geometry(_prop_kernel_dims(flags, n, img))
        tiles = math.ceil(n / 8)
        assert g["tile_rows"] == 8 and g["cluster"] in (1, 2, 4, 8), (n, g)
        assert g["blocks"] == tiles * g["cluster"] <= fused.SMS, (n, g)
        assert g["cluster"] == 8 or 2 * g["blocks"] > fused.SMS, (n, g)
        smem = _prop_bwd_smem(_prop_kernel_dims(flags, n, img))
        assert fused.MAX_SMEM // 2 < smem <= fused.MAX_SMEM, (n, smem)  # one block an SM
        if n == 160:
            assert g["cluster"] == 4 and g["blocks"] == 80, (n, g)


def test_wrappers_pass_the_backward_geometry_to_the_c_entries(seen, monkeypatch):
    """The MLP and propagation backwards hand the host's geometry to their C
    entries (the library is a stand-in that records it)."""
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(fused, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(fc, "_stream", lambda device: ctypes.c_void_p(0))
    x = torch.rand(160, 54, generator=gen)
    params = [(torch.rand(54, 256, generator=gen), torch.rand(256, generator=gen)),
              (torch.rand(256, 4, generator=gen), torch.rand(4, generator=gen))]
    acts = fused.mlp_plain_acts(x, params, ("elu", "id"))
    fused.fused_mlp_bwd(x, params, ("elu", "id"), acts, torch.rand(160, 4, generator=gen))
    g = fused.mlp_bwd_geometry(160, [54, 256, 4])
    assert list(seen["sqair_fused_mlp_bwd"][12]) == [g["tile_rows"], g["cluster"], g["blocks"],
                                                     g["smem"]]
    shape = dict(n=13, S=2, img=[12, 12], glimpse=[5, 5], n_what=6, U=40, SP=20, WB=16, MH=12)
    dims = chip_smoke.prop_dims(shape)
    args, weights = chip_smoke.prop_inputs(torch, fc, shape, gen, "cpu")
    fwd = fc.prop_plain_fwd(*args, weights, dims)
    saved = (fwd[0], fwd[2], fwd[3], fwd[5], fwd[6], fwd[7], fwd[9])
    fc._bwd_cuda(*args, weights, saved, fwd[10], tuple(torch.ones_like(t) for t in fwd[:10]),
                 dims)
    kd = [13, 2, 12, 12, 5, 5, 6, 40, 20, 16, 12]
    assert list(seen["sqair_fused_prop_bwd"][1]) == kd
    g = fc.prop_bwd_geometry(kd)
    assert list(seen["sqair_fused_prop_bwd"][2]) == [g["tile_rows"], g["cluster"], g["blocks"]]


def _glimpse_kernel_dims(shape):
    return [shape["n"], *shape["img"], *shape["glimpse"], shape["d_mi"], shape["d_m"],
            shape["d1"], shape["d2"], shape["n_what"]]


@pytest.mark.parametrize("config,train,fuse", SETTINGS)
def test_glimpse_backward_geometry_fills_the_card(config, train, fuse):
    """One block an SM, clusters of 1-8 blocks over 8-row tiles: the widest
    cluster whose blocks all fit the card at once (4 at 160 rows: 80
    blocks), at the glimpse encoder's main-path shapes (masked and not) and
    at tile edges; the tile's state fits a block's 227 KB."""
    shapes = _shapes("fused_glimpse", config, train, fuse)
    flags, _, _, T, img = _config(config)
    # both switches fuse discovery at the pedestrian flags: no glimpse calls
    assert bool(shapes) == (fuse and not chip_smoke.disc_fusable(flags))
    base = chip_smoke.glimpse_shapes(flags, 160, T, img)
    for s in shapes + [dict(sh, n=n) for sh, _ in base for n in (1, 3, 8, 9, 161)]:
        dims = _glimpse_kernel_dims(s)
        g = fg.glimpse_bwd_geometry(dims)
        tiles = math.ceil(s["n"] / 8)
        assert g["tile_rows"] == 8 and g["cluster"] in (1, 2, 4, 8), (s, g)
        assert g["blocks"] == tiles * g["cluster"] <= fused.SMS, (s, g)
        assert g["cluster"] == 8 or 2 * g["blocks"] > fused.SMS, (s, g)
        assert _glimpse_bwd_smem(dims, bool(s["d_mi"])) <= fused.MAX_SMEM, s
        if s["n"] == 160:
            assert g["cluster"] == 4 and g["blocks"] == 80, (s, g)


@pytest.mark.parametrize("disc", (False, True))
@pytest.mark.parametrize("config,train,fuse", SETTINGS)
def test_prop_forward_geometry_fills_the_card(config, train, fuse, disc):
    """The propagation forward's clusters: the backward's rule (4 at 160
    rows: 80 blocks), at the main path's propagation shape with both
    switches (release flags and DISC_FLAGS) and at tile edges; the tile's
    forward state fits a block's 227 KB, one block an SM."""
    flags, _, _, _, img = _config(config, disc)
    prop = [s["n"] for s in _shapes("fused_prop", config, train, fuse, disc)]
    assert bool(prop) == fuse
    for n in prop + [1, 3, 8, 9, 161]:
        dims = _prop_kernel_dims(flags, n, img)
        g = fc.prop_fwd_geometry(dims)
        assert g == fc.prop_bwd_geometry(dims), (n, g)
        assert g["blocks"] == math.ceil(n / 8) * g["cluster"] <= fused.SMS, (n, g)
        assert g["cluster"] == 8 or 2 * g["blocks"] > fused.SMS, (n, g)
        smem = _prop_fwd_smem(dims)
        assert fused.MAX_SMEM // 2 < smem <= fused.MAX_SMEM, (n, smem)  # one block an SM
        if n == 160:
            assert g["cluster"] == 4 and g["blocks"] == 80, (n, g)


def test_tile_state_geometry_at_the_edges():
    """8 blocks a tile while the card holds them, then the widest cluster
    that fits, 1 where even that does not."""
    SMS = fused.SMS
    for n, cluster in [(1, 8), (8, 8), (9, 8), (16 * 8, 8), (17 * 8, 4), (160, 4), (161, 4),
                       (33 * 8, 4), (34 * 8, 2), (66 * 8 + 1, 1), (4800, 1)]:
        g = fused.tile_state_geometry(n)
        assert g["cluster"] == cluster, (n, g)
        assert g["blocks"] == math.ceil(n / 8) * cluster
        assert g["blocks"] <= SMS or cluster == 1


def test_glimpse_and_prop_forward_wrappers_pass_the_geometry(seen, monkeypatch):
    """The glimpse backward and the propagation forward hand the host's
    geometry to their C entries (the library is a stand-in that records
    it)."""
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(fused, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(fg, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(fg, "_stream", lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(fc, "_stream", lambda device: ctypes.c_void_p(0))
    shape = dict(n=13, img=[12, 12], glimpse=[5, 5], d1=16, d2=16, n_what=6, d_mi=8, d_m=4)
    args = chip_smoke.glimpse_inputs(torch, shape, gen, "cpu")
    dims = chip_smoke.glimpse_dims(shape)
    want = fg.glimpse_plain_fwd(*args, dims)
    saved = tuple(want[2:5]) + (want[1],) + tuple(want[5:])
    fg.fused_glimpse_bwd(*args[:6], saved, torch.ones(13, 6), torch.ones(13, 6), dims)
    kd = _glimpse_kernel_dims(shape)
    assert list(seen["sqair_fused_glimpse_bwd"][1]) == kd
    g = fg.glimpse_bwd_geometry(kd)
    assert list(seen["sqair_fused_glimpse_bwd"][2]) == [g["tile_rows"], g["cluster"], g["blocks"]]
    pshape = dict(n=13, S=2, img=[12, 12], glimpse=[5, 5], n_what=6, U=40, SP=20, WB=16, MH=12)
    pargs, weights = chip_smoke.prop_inputs(torch, fc, pshape, gen, "cpu")
    fc._fwd_cuda(*pargs, weights, chip_smoke.prop_dims(pshape))
    kd = [13, 2, 12, 12, 5, 5, 6, 40, 20, 16, 12]
    assert list(seen["sqair_fused_prop"][1]) == kd
    g = fc.prop_fwd_geometry(kd)
    assert list(seen["sqair_fused_prop"][2]) == [g["tile_rows"], g["cluster"], g["blocks"]]


def _glimpse_fwd_smem(dims, masked):
    """Bytes of the glimpse forward's shared memory, as csrc/fused_glimpse.cu
    fwd_smem lays it out for the kernel dims (a copy, as ``_prop_bwd_smem``):
    the mask and the glimpses, which live through the call, then one region
    for the mask MLP's rows (mask input, hidden) and, after it, the
    encoder's (e1, e2), [8][width rounded up to 4] each, then the products'
    ring (which the crops borrow) and their partial sums."""
    _, H, W, gh, gw, d_mi, d_m, d1, d2, _ = dims
    G = gh * gw
    live = 8 * _r4(G) * (2 if masked else 1)
    region = max(8 * (_r4(d_mi) + _r4(d_m)) if masked else 0, 8 * (_r4(d1) + _r4(d2)))
    ring = max(_RING, _r4(_sparse_crop_floats(H, W, gh, gw, False)))
    return 4 * (live + region + ring + _PARTS)


@pytest.mark.parametrize("config,train,fuse", SETTINGS)
def test_glimpse_forward_geometry_fills_the_card(config, train, fuse):
    """The glimpse forward's clusters: the backward's rule (4 at 160 rows: 80
    blocks), at the glimpse encoder's main-path shapes (masked and not) and
    at tile edges; the tile's state fits a block's 227 KB, one block an
    SM."""
    shapes = _shapes("fused_glimpse", config, train, fuse)
    flags, _, _, T, img = _config(config)
    # both switches fuse discovery at the pedestrian flags: no glimpse calls
    assert bool(shapes) == (fuse and not chip_smoke.disc_fusable(flags))
    base = chip_smoke.glimpse_shapes(flags, 160, T, img)
    for s in shapes + [dict(sh, n=n) for sh, _ in base for n in (1, 3, 8, 9, 161)]:
        dims = _glimpse_kernel_dims(s)
        g = fg.glimpse_fwd_geometry(dims)
        assert g == fg.glimpse_bwd_geometry(dims), (s, g)
        tiles = math.ceil(s["n"] / 8)
        assert g["tile_rows"] == 8 and g["cluster"] in (1, 2, 4, 8), (s, g)
        assert g["blocks"] == tiles * g["cluster"] <= fused.SMS, (s, g)
        assert g["cluster"] == 8 or 2 * g["blocks"] > fused.SMS, (s, g)
        assert _glimpse_fwd_smem(dims, bool(s["d_mi"])) <= fused.MAX_SMEM, s
        if s["n"] == 160:
            assert g["cluster"] == 4 and g["blocks"] == 80, (s, g)


def _disc_kernel_dims(flags, n, img=chip_smoke.IMG):
    shape = chip_smoke.disc_shape(flags, n, img)
    return [n, shape["S"], *shape["img"], *shape["glimpse"], shape["n_what"], shape["U"],
            shape["SP"], shape["C"]]


def _disc_bwd_smem(dims):
    """Bytes of the discovery backward's shared memory, as csrc/fused_disc.cu
    disc_bwd_smem lays it out for the kernel dims (a copy, as
    ``_prop_bwd_smem``): the state that lives across a slot, the largest
    region a phase of a slot lays out (the steps predictor; the head, the
    glimpse encoder and the crop's gradient; the estimator; the
    transition), the products' ring (which the crops borrow) and their
    partial sums, each array rounded up to 4 floats."""
    _, _, H, W, gh, gw, nw, U, SP, C = dims
    G, d_rnn, d_spf = gh * gw, U + C + nw + 5, U + nw
    n = 8
    lu = _r4(U)
    live = sum(_r4(n * w) for w in (1, 1, 1, nw, 4, U, U, C, d_spf, 4))
    phases = ([n * _r4(SP)], [n * _r4(2 * nw), n * lu, n * lu, n * _r4(G)],
              [n * 8, n * lu, n * lu], [n * lu, n * _r4(d_rnn)])
    region = max(sum(_r4(w) for w in ph) for ph in phases)
    ring = max(_RING, _r4(_sparse_crop_floats(H, W, gh, gw, True)))
    return 4 * (live + region + ring + _PARTS)


@pytest.mark.parametrize("config,train,fuse", SETTINGS)
def test_disc_backward_geometry_fills_the_card(config, train, fuse):
    """The discovery backward's clusters at DISC_FLAGS: the widest cluster
    whose blocks all fit the card at once (4 at 160 rows: 80 blocks), at the
    main path's discovery shape with both switches and at tile edges; the
    tile's state fits a block's 227 KB, one block an SM."""
    flags, _, _, _, img = _config(config, disc=True)
    disc = [s["n"] for s in _shapes("fused_disc", config, train, fuse, disc=True)]
    assert bool(disc) == fuse
    for n in disc + [1, 3, 8, 9, 161]:
        dims = _disc_kernel_dims(flags, n, img)
        g = fc.disc_bwd_geometry(dims)
        tiles = math.ceil(n / 8)
        assert g["tile_rows"] == 8 and g["cluster"] in (1, 2, 4, 8), (n, g)
        assert g["blocks"] == tiles * g["cluster"] <= fused.SMS, (n, g)
        assert g["cluster"] == 8 or 2 * g["blocks"] > fused.SMS, (n, g)
        smem = _disc_bwd_smem(dims)
        assert fused.MAX_SMEM // 2 < smem <= fused.MAX_SMEM, (n, smem)  # one block an SM
        if n == 160:
            assert g["cluster"] == 4 and g["blocks"] == 80, (n, g)


def test_glimpse_forward_and_disc_backward_wrappers_pass_the_geometry(seen, monkeypatch):
    """The glimpse forward and the discovery backward hand the host's
    geometry to their C entries (the library is a stand-in that records
    it)."""
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(fg, "_stream", lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(fc, "_stream", lambda device: ctypes.c_void_p(0))
    shape = dict(n=13, img=[12, 12], glimpse=[5, 5], d1=16, d2=16, n_what=6, d_mi=8, d_m=4)
    args = chip_smoke.glimpse_inputs(torch, shape, gen, "cpu")
    fg._fwd_cuda(*args, chip_smoke.glimpse_dims(shape), save=True)
    kd = _glimpse_kernel_dims(shape)
    assert list(seen["sqair_fused_glimpse"][1]) == kd
    g = fg.glimpse_fwd_geometry(kd)
    assert list(seen["sqair_fused_glimpse"][2]) == [g["tile_rows"], g["cluster"], g["blocks"]]
    dshape = dict(n=13, S=2, img=[12, 12], glimpse=[5, 5], n_what=6, U=40, SP=20, C=24)
    frames = torch.rand((13, 12, 12), generator=gen)
    dargs, dweights = chip_smoke.disc_inputs(torch, fc, dshape, gen, "cpu", frames)
    ddims = chip_smoke.disc_dims(dshape)
    fwd = fc.disc_plain_fwd(*dargs, dweights, ddims)
    saved = (fwd[0], fwd[2], fwd[3], fwd[5], fwd[6], fwd[7])
    fc._disc_bwd_cuda(*dargs, dweights, saved, fwd[9], fwd[10], fwd[11],
                      tuple(torch.ones_like(t) for t in fwd[:9]), ddims)
    kd = [13, 2, 12, 12, 5, 5, 6, 40, 20, 24]
    assert list(seen["sqair_fused_disc_bwd"][1]) == kd
    g = fc.disc_bwd_geometry(kd)
    assert list(seen["sqair_fused_disc_bwd"][2]) == [g["tile_rows"], g["cluster"], g["blocks"]]


def _flags_shapes(kernel, config, train, fuse):
    """``kernel``'s shapes in a step of the configuration, with and without
    DISC_LEVERS (at the release flags: the release flags and DISC_FLAGS)."""
    out = []
    for disc in (False, True):
        flags = _config(config, disc)[0]
        out += [(flags, s) for s in _shapes(kernel, config, train, fuse, disc)]
    return out


def _gru_bwd_smem(units):
    """Bytes of the GRU backward's shared memory, as csrc/fused_bwd.cu
    gru_bwd_smem_floats lays it out (a copy, as ``_prop_bwd_smem``): the
    products' ring and partial sums, then the tile's dc_in, drh [8][units]
    and da [8][2 units], widths rounded up to 4."""
    return 4 * (_RING + _PARTS + 8 * (2 * _r4(units) + _r4(2 * units)))


@pytest.mark.parametrize("config,train,fuse", SETTINGS + CONV_SETTINGS)
def test_gru_backward_geometry_fills_the_card(config, train, fuse):
    """Phase A of the GRU backward at every GRU shape of a step (release
    flags and DISC_FLAGS) and at tile edges: clusters of 1-8 blocks over
    8-row tiles that fill the card where n allows (8 at 160 rows: 160
    blocks; 4 at 480: 240), two blocks an SM in shared memory."""
    shapes = _flags_shapes("fused_gru", config, train, fuse)
    assert shapes
    edges = [dict(n=n, dx=360, units=256) for n in (1, 7, 9, 161, 481)]
    for s in [s for _, s in shapes] + edges:
        g = fused.gru_bwd_geometry(s["n"], s["dx"], s["units"])
        tiles = math.ceil(s["n"] / 8)
        assert g["tile_rows"] == 8 and g["cluster"] in (1, 2, 4, 8), (s, g)
        assert g["blocks"] == tiles * g["cluster"], (s, g)
        assert g["blocks"] >= min(fused.SMS, tiles * 8), (s, g)
        assert g["smem"] == _gru_bwd_smem(s["units"]), (s, g)
        assert 2 * g["smem"] <= fused.MAX_SMEM, (s, g)  # two blocks an SM
        if s["n"] == 160:
            assert g["cluster"] == 8 and g["blocks"] == 160, (s, g)
        if s["n"] == 480:
            assert g["cluster"] == 4 and g["blocks"] == 240, (s, g)


def _disc_fwd_smem(dims):
    """Bytes of the discovery forward's shared memory, as csrc/fused_disc.cu
    disc_fwd_smem lays it out for the kernel dims (a copy, as
    ``_prop_fwd_smem``): the state that lives across slots (rin, spf, the
    transition's previous h), the largest region a phase of a slot lays out
    (the glimpse and its encoder; the estimator, its st8 past the glimpse's
    gbuf; the steps predictor), the ring and the partial sums; [8][width
    rounded up to 4] each."""
    _, _, H, W, gh, gw, nw, U, SP, C = dims
    G, d_rnn, d_spf = gh * gw, U + C + nw + 5, U + nw
    live = sum(8 * _r4(w) for w in (d_rnn, d_spf, U))
    glimpse = sum(8 * _r4(w) for w in (G, U, U, 2 * nw))
    estimator = max(2 * 8 * _r4(U), 8 * _r4(G)) + 8 * 8
    region = max(glimpse, estimator, 8 * _r4(SP))
    ring = max(_RING, _r4(_sparse_crop_floats(H, W, gh, gw, False)))
    return 4 * (live + region + ring + _PARTS)


@pytest.mark.parametrize("config,train,fuse", SETTINGS)
def test_disc_forward_geometry_fills_the_card(config, train, fuse):
    """The discovery forward's launches at DISC_FLAGS, at the main path's
    discovery shape with both switches and at tile edges: the slots' widest
    cluster whose blocks all fit the card at once (4 at 160 rows: 80
    blocks), one block an SM, the tile's state within 227 KB; the input
    encoder's launch the MLP forward's at [H W, U, U], filling the card where
    n allows."""
    shapes = _flags_shapes("fused_disc", config, train, fuse)
    assert bool(shapes) == fuse
    flags, _, _, _, img = _config(config, disc=True)
    for n in [s["n"] for _, s in shapes] + [1, 3, 8, 9, 161]:
        dims = _disc_kernel_dims(flags, n, img)
        g = fc.disc_fwd_geometry(dims)
        tiles = math.ceil(n / 8)
        assert g["tile_rows"] == 8 and g["cluster"] in (1, 2, 4, 8), (n, g)
        assert g["blocks"] == tiles * g["cluster"] <= fused.SMS, (n, g)
        assert g["cluster"] == 8 or 2 * g["blocks"] > fused.SMS, (n, g)
        smem = _disc_fwd_smem(dims)
        assert fused.MAX_SMEM // 2 < smem <= fused.MAX_SMEM, (n, smem)  # one block an SM
        enc = g["encoder"]
        assert enc == fused.mlp_fwd_geometry(n, [dims[2] * dims[3], dims[7], dims[7]]), (n, g)
        assert 1 <= enc["cluster"] <= 8 and enc["blocks"] >= min(fused.SMS, tiles * 8), (n, g)
        assert 2 * enc["smem"] <= fused.MAX_SMEM, (n, g)
        if n == 160:
            assert g["cluster"] == 4 and g["blocks"] == 80, (n, g)
            assert enc["cluster"] == 8 and enc["blocks"] == 160, (n, g)


def test_gru_backward_and_disc_forward_wrappers_pass_the_geometry(seen, monkeypatch):
    """The GRU backward and the discovery forward hand the host's geometry
    to their C entries (the library is a stand-in that records it), the
    GRU's with dx and dh skipped or not."""
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(fused, "_on_cuda", lambda name, t: True)
    n, d_x, units = 13, 7, 12
    x, h = torch.rand(n, d_x, generator=gen), torch.rand(n, units, generator=gen)
    mats = [torch.rand(*s, generator=gen) for s in ((d_x, 2 * units), (units, 2 * units),
                                                    (d_x, units), (units, units),
                                                    (n, 2 * units), (n, units), (n, units))]
    g = fused.gru_bwd_geometry(n, d_x, units)
    for need_dx, need_dh in ((True, True), (False, True), (True, False)):
        fused.fused_gru_bwd(x, h, *mats, need_dx=need_dx, need_dh=need_dh)
        args = seen["sqair_fused_gru_bwd"]
        assert list(args[23]) == [g["tile_rows"], g["cluster"], g["blocks"], g["smem"]]
        assert (args[12].value is not None) == need_dx and (args[13].value is not None) == need_dh
    monkeypatch.setattr(fc, "_stream", lambda device: ctypes.c_void_p(0))
    dshape = dict(n=13, S=2, img=[12, 12], glimpse=[5, 5], n_what=6, U=40, SP=20, C=24)
    frames = torch.rand((13, 12, 12), generator=gen)
    dargs, dweights = chip_smoke.disc_inputs(torch, fc, dshape, gen, "cpu", frames)
    fc._disc_fwd_cuda(*dargs, dweights, chip_smoke.disc_dims(dshape))
    kd = [13, 2, 12, 12, 5, 5, 6, 40, 20, 24]
    assert list(seen["sqair_fused_disc"][1]) == kd
    g = fc.disc_fwd_geometry(kd)
    enc = g["encoder"]
    assert list(seen["sqair_fused_disc"][2]) == [
        g["tile_rows"], g["cluster"], g["blocks"], enc["tile_rows"], enc["cluster"],
        enc["blocks"], enc["smem"], *enc["wk"]]


LONG_K_SHAPES = {("conv", 10816): "the input encoder", ("conv", 1600): "the glimpse encoder"}


@pytest.mark.parametrize("disc", (False, True))
@pytest.mark.parametrize("config,train,fuse", SETTINGS + CONV_SETTINGS)
def test_long_k_path_is_the_conv_encoders_alone(config, train, fuse, disc):
    """The long-K kernels take exactly the conv step's one-layer 10816 -> 256
    and 1600 -> 256 calls, forward and backward (the wrappers ask
    ``is_long_k`` for both), and no release or pedestrian call, the 4800-row
    decoders, the conv decoder's 50 -> 400 seed, nor the discovery unroll's
    input encoder (#7, two layers, launched from csrc/fused_disc.cu)."""
    flags, _, _, _, img = _config(config, disc)
    long_k = []
    for s in _shapes("fused_mlp", config, train, fuse, disc):
        dims = [s["d_in"]] + s["widths"]
        if fused.is_long_k(s["n"], dims):
            long_k.append((s["n"], dims))
        if s["n"] == 4800 or s["d_in"] == 50:
            assert not fused.is_long_k(s["n"], dims), s
    if config == "conv":
        assert sorted(long_k) == [(160, [1600, 256]), (160, [10816, 256])], long_k
    else:
        assert long_k == [], long_k
    for n in [s["n"] for s in _shapes("fused_disc", config, train, fuse, disc)] + [1, 161]:
        dims = _disc_kernel_dims(flags, n, img)
        assert not fused.is_long_k(n, [dims[2] * dims[3], dims[7], dims[7]])


LONG_K_CASES = ([(n, k, d) for n in (1, 7, 32, 33, 64, 96, fused.LONG_K_MAX_ROWS)
                 for k, d in ((fused.LONG_K_MAX, 256), (1600, 256), (1030, 100))]
                + [(n, fused.LONG_K_MIN, fused.LONG_K_MAX_WIDTH) for n in (1, 7, 32)])


@pytest.mark.parametrize("n,k,d", LONG_K_CASES)
def test_long_k_geometry_fills_the_card(n, k, d):
    """The long-K launches at the conv encoders' widths, a ragged K and D
    and the widest layer, at tile edges and the row limit (the widest layer
    at one row tile: two take 128 blocks)."""
    assert fused.is_long_k(n, [k, d])
    g, _ = _check_long_k_geometry(n, [k, d])
    assert g["blocks"] <= fused.LONG_K_MAX_BLOCKS


def test_long_k_limits():
    """One layer of LONG_K_MIN to LONG_K_MAX inputs and at most
    LONG_K_MAX_WIDTH outputs at 1 to LONG_K_MAX_ROWS rows, whose forward
    launch takes at most LONG_K_MAX_BLOCKS blocks; nothing else."""
    lim = fused.LONG_K_MAX_ROWS
    assert fused.is_long_k(lim, [fused.LONG_K_MIN, 256])
    assert fused.is_long_k(lim, [fused.LONG_K_MAX, 256])
    assert not fused.is_long_k(lim + 1, [10816, 100])
    assert not fused.is_long_k(160, [fused.LONG_K_MIN - 1, 256])
    assert not fused.is_long_k(160, [fused.LONG_K_MAX + 1, 256])
    # 128 blocks: 16 tiles of 32 x 64 in clusters of 8
    assert fused.mlp_long_k_geometry(128, [1600, 256])["blocks"] == 128
    assert not fused.is_long_k(128, [1600, 256])
    assert not fused.is_long_k(33, [1024, 512])
    assert not fused.is_long_k(160, [10816, 256, 256])
    assert not fused.is_long_k(160, [10816, fused.LONG_K_MAX_WIDTH + 1])
    assert not fused.is_long_k(0, [10816, 256])


def test_wrappers_pass_the_long_k_geometry_to_the_c_entries(seen, monkeypatch):
    """The MLP forward and backward hand the long-K geometry to their
    long-K C entries at a conv encoder's shape, count the call in
    ``launches`` as any other and in ``long_k_calls``; a short-K call
    counts in ``launches`` alone, and ``reset_launches`` clears both."""
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(fused, "_on_cuda", lambda name, t: True)
    fused.reset_launches()
    x = torch.rand(160, 1600, generator=gen)
    params = [(torch.rand(1600, 256, generator=gen), torch.rand(256, generator=gen))]
    y = fused._mlp_fwd_cuda(x, params, ("id",), save=True)[-1]
    g = fused.mlp_long_k_geometry(160, [1600, 256])
    args = seen["sqair_fused_mlp_long_k"]
    assert args[2:6] == (160, 1600, 256, fused.ACTS.index("id"))
    assert list(args[8]) == [g[k] for k in ("tile_rows", "cluster", "blocks", "smem",
                                            "col_tiles", "per")]
    fused.fused_mlp_bwd(x, params, ("id",), [y], torch.rand(160, 256, generator=gen))
    b = fused.mlp_bwd_long_k_geometry(160, [1600, 256])
    args = seen["sqair_fused_mlp_bwd_long_k"]
    assert args[3:7] == (160, 1600, 256, fused.ACTS.index("id"))
    assert list(args[12]) == [b[k] for k in ("tile_rows", "col_blocks", "steps", "blocks",
                                             "smem")]
    assert args[2].value is not None  # dx
    assert "sqair_fused_mlp" not in seen and "sqair_fused_mlp_bwd" not in seen
    xs = torch.rand(160, 54, generator=gen)
    short = [(torch.rand(54, 256, generator=gen), torch.rand(256, generator=gen))]
    fused._mlp_fwd_cuda(xs, short, ("elu",), save=True)
    assert "sqair_fused_mlp" in seen
    assert dict(fused.launches) == {"fused_mlp": 2, "fused_mlp_bwd": 1}
    assert dict(fused.long_k_calls) == {"fused_mlp": 1, "fused_mlp_bwd": 1}
    fused.reset_launches()
    assert not fused.launches and not fused.long_k_calls


def _conv_step_mlp_calls(monkeypatch):
    """The fused_mlp and fused_mlp_bwd calls of one conv train step on the
    CPU, (args, kwargs) each, at small widths (n_units 1, 2 slots, B 4, k 2,
    T 3) whose encoders keep the conv cell's long K: channels 4,64 on 50x50
    frames and 20x20 glimpses, 10816 and 1600 inputs."""
    from sqair_tpu_torch.configs import conv_mnist_model
    from sqair_tpu_torch.ops.noise import GeneratorNoise

    flags = dict(n_units=1, n_what=8, n_steps_per_image=2, glimpse_size=20, k_particles=2,
                 conv_channels="4,64", model_config="sqair_tpu/configs/conv_mnist_model.py")
    monkeypatch.delenv("SQAIR_FUSE_GLIMPSE", raising=False)
    monkeypatch.delenv("SQAIR_FUSE_CELLS", raising=False)
    model = conv_mnist_model.load(flags, (50, 50), device="cpu", seed=0)
    rs = torch.Generator().manual_seed(5)
    T, B = 3, 4
    obs = torch.rand((T, B, 50, 50), generator=rs) * 0.2
    obs[:, :, 10:30, 12:32] += 0.8
    nums = torch.zeros((T, B, 3))
    nums[:, :, 1] = 1
    calls = {"fused_mlp": [], "fused_mlp_bwd": []}

    def spy(name, fn):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return call
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with monkeypatch.context() as m:
            m.setattr(fused, "fused_mlp", spy("fused_mlp", fused.fused_mlp))
            m.setattr(fused, "fused_mlp_bwd", spy("fused_mlp_bwd", fused.fused_mlp_bwd))
            target, _ = model.loss_and_metrics(
                obs, GeneratorNoise(torch.Generator().manual_seed(1), "cpu"), nums,
                record_mode="train")
            target.backward()
    finally:
        torch.set_num_threads(threads)
    shapes = chip_smoke.main_path_shapes(flags, B, 2, T, train=True, img=(50, 50))
    return calls, shapes


def test_long_k_calls_count_the_conv_encoders_of_a_train_step(seen, monkeypatch):
    """Every MLP call of a conv train step (``_conv_step_mlp_calls``),
    replayed through the CUDA wrappers with a stand-in library:
    ``fused.long_k_calls`` counts the encoders' T + 3 S T calls, forward
    and backward, and ``fused.launches`` one per wrapper call, its keys and
    counts those of ``expected_launches`` (which the benchmark's capture is
    held to).  At the benchmark's conv cell that is 100 forward and 100
    backward calls a step, at its MLP cell none."""
    calls, shapes = _conv_step_mlp_calls(monkeypatch)
    monkeypatch.setattr(fused, "_on_cuda", lambda name, t: True)
    fused.reset_launches()
    for args, _ in calls["fused_mlp"]:
        x, params, transfers = args
        fused._mlp_fwd_cuda(x.reshape(-1, x.shape[-1]).contiguous(),
                            [(w.detach(), b.detach()) for w, b in params], tuple(transfers),
                            save=True)
    for args, kwargs in calls["fused_mlp_bwd"]:
        fused.fused_mlp_bwd(*args, **kwargs)
    T, S = 3, 2
    assert dict(fused.long_k_calls) == {"fused_mlp": T + 3 * S * T, "fused_mlp_bwd": T + 3 * S * T}
    expected = chip_smoke.expected_launches(shapes, 1, backward=True)
    assert dict(fused.launches) == {k: expected[k] for k in ("fused_mlp", "fused_mlp_bwd")}
    assert chip_smoke.expected_long_k(fused, shapes, 1, backward=True) == dict(fused.long_k_calls)
    fused.reset_launches()

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmark"))
    from harness import runner, spec, yardstick

    for cell, want in (("conv_mnist-train", 100), ("mlp_release-train-fused", 0)):
        cell_shapes = runner.main_shapes(spec.cell(cell))
        n = sum(c for kn, s, c in cell_shapes
                if kn == "fused_mlp" and fused.is_long_k(s["n"], [s["d_in"]] + s["widths"]))
        assert n == want, cell
        assert set(yardstick.expected_launches(cell_shapes, 10, backward=True)) <= {
            k + suffix for k in yardstick.FORWARD for suffix in ("", "_bwd")}
