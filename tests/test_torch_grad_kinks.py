"""chip_smoke.py's train-check, on the CPU at two sequences of three frames:
the kinks of a train step's gradient found between two runs (a crop or
paste coordinate on other sides of an integer, a relu input of other
sign, a presence draw, a fused propagation or discovery crop's
coordinates), the masking
of the gradient through them, and the referee gate, distances and pairs
that ``train_check`` reports."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.data import DeviceDatasetSampler, create_seq_dataset, make_template_bank
from sqair_tpu_torch.models.air import AIRDecoder, AIREncoder
from sqair_tpu_torch.ops import distributions as D
from sqair_tpu_torch.ops import fused_glimpse as fg
from sqair_tpu_torch.ops import stn
from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

IMG, GLIMPSE = (50, 50), (20, 20)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for the module (see tests/torch_parity.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_and_batch(levers=None):
    flags = json.loads(chip_smoke.RELEASE_FLAGS.read_text())
    flags.update(batch_size=2, font_timesteps=3, k_particles=2, **(levers or {}))
    data = create_seq_dataset(n_samples=4, n_timesteps=3, canvas_size=IMG, obj_size=(28, 28),
                              n_objects=(1, 2), seed=1,
                              templates=make_template_bank(16, 28, seed=0))
    imgs = data["imgs"].astype("float32") / 255.0
    model = mlp_mnist_model.load(flags, imgs.shape[2:], mean_img=imgs.mean((0, 1)),
                                 device="cpu", seed=0)
    batch = DeviceDatasetSampler(data, "cpu").sample(torch.Generator().manual_seed(4), 2)
    return flags, model, batch


@pytest.mark.parametrize("fused", [False, True])
def test_kinks_crossed_finds_the_rows_whose_coordinates_cross(fused):
    gen = torch.Generator().manual_seed(0)
    crop_a = torch.randn(64, 4, generator=gen, dtype=torch.float64)
    paste_a = torch.randn(8, 3, 4, generator=gen, dtype=torch.float64)
    # a small shift of rows 0-31 / objects 0-3 moves some coordinates
    # across an integer and no coordinate by half a unit
    crop_b, paste_b = crop_a.clone(), paste_a.clone()
    crop_b[:32, 2:] += 0.02
    paste_b[:4, :, 2:] += 0.02
    relu_a = torch.tensor([0.5, -1e-7, 2.0])
    relu_b = torch.tensor([0.5, 1e-7, 2.0])
    pres_a, pres_b = torch.tensor([1.0, 0.0, 1.0]), torch.tensor([1.0, 1.0, 1.0])
    # a fused propagation call's record: both crops' where of 8 slots x 8 rows,
    # the first crop moved as above, the second not
    prop_a = torch.cat([crop_a, crop_a.flip(0)], -1).reshape(8, 8, 8)
    prop_b = torch.cat([crop_b, crop_a.flip(0)], -1).reshape(8, 8, 8)
    # a fused discovery call's record: its crop's where of 8 slots x 8 rows
    disc_a, disc_b = crop_a.reshape(8, 8, 4), crop_b.reshape(8, 8, 4)
    a = dict(glimpse=[crop_a], paste=[paste_a], relu=[relu_a], presence=[pres_a], prop=[prop_a],
             disc=[disc_a])
    b = dict(glimpse=[crop_b], paste=[paste_b], relu=[relu_b], presence=[pres_b], prop=[prop_b],
             disc=[disc_b])
    got, flips = chip_smoke.kinks_crossed(torch, fg, stn, a, b, fused, IMG, GLIMPSE)

    def floors(u):
        return torch.floor(u)

    def kernel_crossed(x, y):  # the propagation kernel's coordinates, either switch
        _, (_, uyx, _), (_, uxx, _) = fg.coords_and_interp(x, *IMG, *GLIMPSE)
        _, (_, uyy, _), (_, uxy, _) = fg.coords_and_interp(y, *IMG, *GLIMPSE)
        return torch.any(floors(torch.cat([uyx, uxx], -1)) != floors(torch.cat([uyy, uxy], -1)),
                         -1)

    want_prop = kernel_crossed(crop_a, crop_b)
    assert want_prop[:32].any() and not want_prop[32:].any()
    assert torch.equal(got["prop"][0], want_prop)
    assert torch.equal(got["disc"][0], want_prop)  # the same rows, one crop each

    if fused:
        _, (_, uya, _), (_, uxa, _) = fg.coords_and_interp(crop_a, *IMG, *GLIMPSE)
        _, (_, uyb, _), (_, uxb, _) = fg.coords_and_interp(crop_b, *IMG, *GLIMPSE)
    else:
        uya, uxa = stn.crop_coords(stn.to_coords(crop_a), GLIMPSE, IMG)
        uyb, uxb = stn.crop_coords(stn.to_coords(crop_b), GLIMPSE, IMG)
    want_crop = torch.any(floors(torch.cat([uya, uxa], -1)) != floors(torch.cat([uyb, uxb], -1)), -1)
    pa = torch.cat(stn.paste_coords(stn.to_coords(paste_a), GLIMPSE, IMG), -1)
    pb = torch.cat(stn.paste_coords(stn.to_coords(paste_b), GLIMPSE, IMG), -1)
    want_paste = torch.any(floors(pa) != floors(pb), -1)
    assert want_crop[:32].any() and not want_crop[32:].any()
    assert want_paste[:4].any() and not want_paste[4:].any()
    assert torch.equal(got["glimpse"][0], want_crop)
    assert torch.equal(got["paste"][0], want_paste)
    assert got["relu"][0].tolist() == [False, True, False]
    assert flips == 1


def test_kinks_masks_the_gradient_only_where_asked():
    flags, model, batch = _model_and_batch()
    _, l2 = mlp_mnist_model.make_optimizer(flags)
    noise = GeneratorNoise(torch.Generator().manual_seed(6), "cpu", record=True)
    with chip_smoke.kinks(torch, AIREncoder, AIRDecoder, D) as rec:
        free, _ = chip_smoke.step_gradients(torch, model, batch["imgs"], batch["nums"], noise, l2)
    assert len(rec["glimpse"]) == 3 * 3 * 3  # 3 calls a slot and frame, 3 slots, 3 frames
    assert len(rec["paste"]) == 1 and len(rec["relu"]) == 1 and rec["presence"]

    def run(fill):
        keep = {kind: [torch.full(x.shape[:-1] if kind != "relu" else x.shape, fill)
                       for x in rec[kind]] for kind in ("glimpse", "paste", "relu")}
        with chip_smoke.kinks(torch, AIREncoder, AIRDecoder, D, keep):
            return chip_smoke.step_gradients(torch, model, batch["imgs"], batch["nums"],
                                             ReplayNoise(noise.table, "cpu"), l2)[0]

    kept = run(True)
    for name, g in free.items():
        assert (g is None) == (kept[name] is None)
        if g is not None:
            assert torch.equal(g, kept[name]), name
    masked = run(False)
    where_bias = [n for n in free if "_where_bias_mlp" in n]
    assert where_bias
    # the where-bias MLP reaches the loss only through the propagation
    # glimpse's where: with every crop and paste row masked it gets none
    for name in where_bias:
        assert torch.count_nonzero(masked[name]) == 0, name
        assert torch.count_nonzero(free[name]) > 0, name


def test_kinks_masks_the_fused_frame_kernels_crops(monkeypatch):
    """The fused calls' crop masks (both switches at DISC_FLAGS, where both
    frame kernels run) cut the same gradient out as the glimpse mask on the
    unfused cores' crops: with every row-slot masked, the step's gradients
    agree with those of the unfused step with every glimpse row masked, per
    parameter within 1e-4 of its largest gradient or twice the two paths'
    distance unmasked, where that is larger; with every row-slot kept, the
    masks change nothing."""
    from sqair_tpu_torch.ops import fused_cells as fc

    flags, model, batch = _model_and_batch(chip_smoke.DISC_LEVERS)
    _, l2 = mlp_mnist_model.make_optimizer(flags)
    noise = GeneratorNoise(torch.Generator().manual_seed(6), "cpu", record=True)

    def grads(switches, keep=None):
        with chip_smoke.switched(switches), \
                chip_smoke.kinks(torch, AIREncoder, AIRDecoder, D, keep, fc) as rec:
            src = noise if not noise.table else ReplayNoise(noise.table, "cpu")
            g, _ = chip_smoke.step_gradients(torch, model, batch["imgs"], batch["nums"], src, l2)
        return g, rec

    def keep_all(rec, cut=()):
        def full(kind, x):  # a fused call's mask is per row-slot, flat
            k = torch.full(x.shape if kind == "relu" else x.shape[:-1], kind not in cut)
            return k.flatten() if kind in ("prop", "disc") else k
        return {kind: [full(kind, x) for x in rec[kind]]
                for kind in ("glimpse", "paste", "relu", "prop", "disc")}

    on = chip_smoke.SWITCHES["disc"]
    free, rec = grads(on)
    assert len(rec["prop"]) == len(rec["disc"]) == 3 and not rec["glimpse"]
    kept, _ = grads(on, keep_all(rec))
    cut, _ = grads(on, keep_all(rec, cut=("prop", "disc")))
    unfused, rec_u = grads({})
    assert len(rec_u["glimpse"]) == 3 * 3 * 3 and not rec_u["prop"] and not rec_u["disc"]
    unfused_cut, _ = grads({}, keep_all(rec_u, cut=("glimpse",)))
    moved = 0
    for name, g in free.items():
        if g is None:
            continue
        assert torch.equal(g, kept[name]), name
        tol = max(1e-4 * float(unfused_cut[name].abs().max()) + 1e-7,
                  2.0 * float((g - unfused[name]).abs().max()))
        assert float((cut[name] - unfused_cut[name]).abs().max()) <= tol, name
        moved += not torch.allclose(cut[name], g, rtol=1e-3, atol=1e-6)
    assert moved > 10


def test_train_check_on_the_cpu():
    flags, model, batch = _model_and_batch()
    disc_flags, disc_model, _ = _model_and_batch(chip_smoke.DISC_LEVERS)
    _, l2 = mlp_mnist_model.make_optimizer(flags)
    tc = chip_smoke.train_check(torch, model, disc_model, batch, flags, disc_flags, l2,
                                torch.device("cpu"))
    assert set(tc["errors"]) == set(chip_smoke.GRADIENT_PAIRS)
    assert set(tc["distance"]) == {"kernels", "plain_on_card", "cpu", "glimpse_kernels",
                                   "glimpse_plain", "cells_kernels", "cells_plain",
                                   "disc_kernels", "disc_plain"}
    for pair, errs in tc["errors"].items():
        assert all(np.isfinite(err) for _, _, err, _ in errs), pair
    # the gate: every gated run within its bound on every parameter
    assert set(tc["gate"]) == set(chip_smoke.REFEREE_GATE)
    for run, gated in tc["gate"].items():
        assert len(gated) == len(tc["distance"][run])
        assert all(np.isfinite(r) and r <= 1.0 for r, _, _, _ in gated), run
    for run, errs in tc["distance"].items():
        assert 0.0 < errs[-1][0] < 1e-2, run
    assert set(tc["masked"]) == {f"{group}.{kind}" for group in ("off_glimpse", "cells", "disc")
                                 for kind in ("glimpse", "paste", "relu", "prop", "disc")}
    assert all(np.isfinite(v) for v in tc["ratio"].values())
