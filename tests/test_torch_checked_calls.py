"""chip_smoke.py's per-call gate of the rollout phases (``checked_calls``),
on the CPU, with stand-ins for the six forward kernels at the release
flags' widths:

- a stand-in that returns its plain version's outputs passes, and its call
  is counted;
- one that moves its main output by 1e-3 of its value fails (the bound is
  1e-5 + 1e-4 |plain|; an output over it is then held to a float64 referee
  at twice the plain version's distance, which a 1e-3 error also fails);
- where cancellation puts float32's own error over the fixed bound, a
  kernel as near float64 as its plain version passes, its call counted as
  refereed, and one four times as far fails;
- a frame kernel that draws a presence otherwise than its plain version
  fails where the uniform lies far from the probability, and counts the call
  as crossed, not gated, where it lies within FLIP_MARGIN of it.
"""
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
from sqair_tpu_torch.ops import fused  # noqa: E402
from sqair_tpu_torch.ops import fused_cells as fc  # noqa: E402
from sqair_tpu_torch.ops import fused_glimpse as fg  # noqa: E402

FLAGS = json.loads(chip_smoke.RELEASE_FLAGS.read_text())
ROWS = 6
KERNELS = ("fused_mlp", "fused_vanilla_rnn", "fused_gru", "fused_glimpse", "fused_prop",
           "fused_disc")


def call_args(kernel, seed=0):
    """(positional arguments, keywords) of one call of the function that
    launches ``kernel``, ROWS rows at the release flags' widths."""
    gen = torch.Generator().manual_seed(seed)
    if kernel in ("fused_mlp", "fused_vanilla_rnn", "fused_gru"):
        shape = next(s for k, s, _ in chip_smoke.main_path_shapes(FLAGS, 2, 3, 2) if k == kernel)
        args = chip_smoke.make_inputs(torch, kernel, dict(shape, n=ROWS), gen, "cpu")
        return args, ({} if kernel == "fused_vanilla_rnn" else {"save": False})
    if kernel == "fused_glimpse":
        shape = chip_smoke.glimpse_shapes(FLAGS, ROWS, 2)[0][0]
        args = chip_smoke.glimpse_inputs(torch, shape, gen, "cpu")
        return args + (chip_smoke.glimpse_dims(shape),), {"save": False}
    if kernel == "fused_prop":
        shape = chip_smoke.prop_shape(FLAGS, ROWS)
        args, weights = chip_smoke.prop_inputs(torch, fc, shape, gen, "cpu")
        return args + (weights, chip_smoke.prop_dims(shape)), {}
    shape = chip_smoke.disc_shape(FLAGS, ROWS)
    frames = torch.rand((ROWS,) + chip_smoke.IMG, generator=gen)
    args, weights = chip_smoke.disc_inputs(torch, fc, shape, gen, "cpu", frames)
    return args + (weights, chip_smoke.disc_dims(shape)), {}


def stand_in(kernel, change=None):
    """A kernel that returns what its launching function would, computed by
    the plain version; ``change`` edits the outputs (a list) first."""
    plain = chip_smoke.kernel_calls(fused, fg, fc)[kernel][2]

    def launch(*args, save=False):
        out = plain(*args)
        out = [out] if kernel == "fused_vanilla_rnn" else list(out)
        if not save and kernel == "fused_mlp":
            out = [None] * (len(out) - 1) + out[-1:]
        elif not save and kernel == "fused_gru":
            out = [out[0], None, None]
        elif not save and kernel == "fused_glimpse":
            out = out[:2]
        if change is not None:
            change(out)
        return out[0] if kernel == "fused_vanilla_rnn" else tuple(out)
    return launch


def run_checked(monkeypatch, kernel, launch, args, kw):
    module, name, _ = chip_smoke.kernel_calls(fused, fg, fc)[kernel]
    monkeypatch.setattr(module, name, launch)
    with chip_smoke.checked_calls(torch, "test") as report:
        out = getattr(module, name)(*args, **kw)
    return out, report


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_kernel_that_agrees_passes_and_is_counted(monkeypatch, kernel):
    args, kw = call_args(kernel)
    launch = stand_in(kernel)
    out, report = run_checked(monkeypatch, kernel, launch, args, kw)
    want = launch(*args, **kw)
    for a, b in zip(chip_smoke.as_tuple(out), chip_smoke.as_tuple(want)):
        assert (a is None and b is None) or torch.equal(a, b)
    st = report[kernel]
    assert st["calls"] == 1 and st["refereed"] == 0 and st["crossed"] == 0
    assert float(st["max_abs_err"]) == 0.0 and float(st["of_tol"]) == 0.0


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_kernel_off_by_1e_3_fails(monkeypatch, kernel):
    args, kw = call_args(kernel)
    main = -1 if kernel == "fused_mlp" else 0

    def off(out):
        out[main] = out[main] * (1.0 + 1e-3)

    with pytest.raises(chip_smoke.Failure, match=kernel):
        run_checked(monkeypatch, kernel, stand_in(kernel, off), args, kw)


def _prop_at_margin(gap):
    """The propagation call's arguments with every previous presence 1 and
    row 0's slot-0 uniform ``gap`` below that slot's probability (the plain
    version draws the presence there)."""
    args, kw = call_args("fused_prop")
    args = list(args)
    args[3] = torch.ones_like(args[3])
    prob = fc.prop_plain_fwd(*args)[6]
    u = args[8].clone()
    u[0, 0, 0] = prob[0, 0, 0] - gap
    args[8] = u
    return tuple(args), kw


def _flip_row0_slot0(out):
    out[7] = out[7].clone()
    out[7][0, 0, 0] = 1.0 - out[7][0, 0, 0]


@pytest.mark.parametrize("gap", [5e-5, 0.3])
def test_a_presence_flip_is_crossed_only_near_its_probability(monkeypatch, gap):
    args, kw = _prop_at_margin(gap)
    if fc.prop_plain_fwd(*args)[6][0, 0, 0] <= gap:
        pytest.fail("the seeded probability is too small for this gap")
    launch = stand_in("fused_prop", _flip_row0_slot0)
    if gap < chip_smoke.FLIP_MARGIN:
        _, report = run_checked(monkeypatch, "fused_prop", launch, args, kw)
        assert report["fused_prop"]["crossed"] == 1
    else:
        with pytest.raises(chip_smoke.Failure, match="presence"):
            run_checked(monkeypatch, "fused_prop", launch, args, kw)


def _cancelling_mlp():
    """An MLP call whose terms (~1e3) are far larger than its outputs, so
    that float32's own error lies over the fixed bound: (arguments, the
    plain version's output, the float64 output)."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn((256, 64), generator=gen, dtype=torch.float64)
    w = (w - w.mean(0)).float()
    x = (1e3 + 0.1 * torch.randn((ROWS, 256), generator=gen)).float()
    params = ((w, torch.zeros(64)),)
    args = (x, params, ("id",))
    y = fused.mlp_plain_acts(*args)[-1]
    y64 = fused.mlp_plain_acts(*chip_smoke.to_double(torch, args))[-1]
    assert (y - y64).abs().max() > chip_smoke.KERNEL_ATOL + chip_smoke.KERNEL_RTOL * y.abs().max()
    return args, y, y64


@pytest.mark.parametrize("factor, passes", [(0.0, True), (4.0, False)])
def test_cancellation_is_held_to_float64(monkeypatch, factor, passes):
    args, y, y64 = _cancelling_mlp()

    def launch(x, params, transfers, save=False):
        # float64's value with ``factor`` times the plain version's error
        return (y64 + factor * (y.double() - y64)).float(),

    if passes:
        _, report = run_checked(monkeypatch, "fused_mlp", launch, args, {})
        st = report["fused_mlp"]
        assert st["refereed"] == 1 and float(st["of_tol"]) > 1.0
        assert float(st["of_referee"]) <= 1.0
    else:
        with pytest.raises(chip_smoke.Failure, match="float64"):
            run_checked(monkeypatch, "fused_mlp", launch, args, {})


def _bwd_args(kernel, seed=0):
    """The backward wrapper's arguments for one call at the release flags'
    first shape of the forward kernel, ROWS rows."""
    gen = torch.Generator().manual_seed(seed)
    shape = next(s for k, s, _ in chip_smoke.main_path_shapes(FLAGS, 2, 3, 2) if k == kernel)
    args = chip_smoke.make_inputs(torch, kernel, dict(shape, n=ROWS), gen, "cpu")
    return chip_smoke.make_bwd_inputs(torch, fused, kernel, args, gen)


@pytest.mark.parametrize("kernel", ["fused_mlp", "fused_vanilla_rnn", "fused_gru"])
@pytest.mark.parametrize("off_by", [0.0, 1e-3])
def test_checked_backward_calls(monkeypatch, kernel, off_by):
    """chip_smoke's per-call gate of the backward wrappers
    (``checked_bwd_calls``, the conv phases' train steps): a backward that
    gives its plain version's gradients passes and is counted, with its
    shape; one whose input gradient is off by 1e-3 of its value fails."""
    name = kernel + "_bwd"
    real = getattr(fused, name)

    def launch(*args, **kw):
        out = list(real(*args, **kw))
        if off_by:
            out[0] = out[0] * (1.0 + off_by)
        return tuple(out)

    monkeypatch.setattr(fused, name, launch)
    bargs = _bwd_args(kernel)
    if off_by:
        with pytest.raises(chip_smoke.Failure, match=name):
            with chip_smoke.checked_bwd_calls(torch, "test"):
                getattr(fused, name)(*bargs)
        return
    with chip_smoke.checked_bwd_calls(torch, "test") as report:
        getattr(fused, name)(*bargs)
    st = report[name]
    assert st["calls"] == 1 and float(st["max_abs_err"]) == 0.0 and st["refereed"] == 0
    (shape, calls), = st["shapes"].items()
    assert calls == 1 and json.loads(shape)[:2] == [ROWS, bargs[0].shape[1]]


def _frame_bwd_args(kernel, seed=0):
    """The frame kernel's backward wrapper's arguments for one call, ROWS
    rows at the release flags' widths: its forward's inputs, what the
    forward saves, and random cotangents."""
    gen = torch.Generator().manual_seed(seed)
    args, _ = call_args(kernel, seed)
    if kernel == "fused_glimpse":
        want = fg.glimpse_plain_fwd(*args)
        saved = tuple(want[2:5]) + (want[1],) + tuple(want[5:])
        dloc, dscale = (torch.randn(want[i].shape, generator=gen) for i in (0, 1))
        return args[:6] + (saved, dloc, dscale, args[-1])
    if kernel == "fused_prop":
        want = fc.prop_plain_fwd(*args)
        cots = tuple(torch.randn(t.shape, generator=gen) for t in want[:10])
        saved = (want[0], want[2], want[3], want[5], want[6], want[7], want[9])
        return args[:-1] + (saved, want[10], cots, args[-1])
    want = fc.disc_plain_fwd(*args)
    cots = tuple(torch.randn(t.shape, generator=gen) for t in want[:9])
    saved = (want[0], want[2], want[3], want[5], want[6], want[7])
    return args[:-1] + (saved, want[9], want[10], want[11], cots, args[-1])


@pytest.mark.parametrize("kernel, module, name", [
    ("fused_glimpse", fg, "fused_glimpse_bwd"), ("fused_prop", fc, "prop_bwd"),
    ("fused_disc", fc, "disc_bwd")])
@pytest.mark.parametrize("off_by", [0.0, 1e-3])
def test_checked_frame_backward_calls(monkeypatch, kernel, module, name, off_by):
    """``checked_bwd_calls(frames=True)`` (the two-rank data-parallel
    steps) also holds the glimpse, propagation and discovery backward
    wrappers: one that gives its plain version's gradients passes and is
    counted; one whose first gradient is off by 1e-3 of its value fails."""
    real = getattr(module, name)

    def launch(*args, **kw):
        out = list(real(*args, **kw))
        if off_by:
            out[0] = out[0] * (1.0 + off_by)
        return tuple(out)

    monkeypatch.setattr(module, name, launch)
    bargs = _frame_bwd_args(kernel)
    if off_by:
        with pytest.raises(chip_smoke.Failure, match=kernel + "_bwd"):
            with chip_smoke.checked_bwd_calls(torch, "test", frames=True):
                getattr(module, name)(*bargs)
        return
    with chip_smoke.checked_bwd_calls(torch, "test", frames=True) as report:
        getattr(module, name)(*bargs)
    st = report[kernel + "_bwd"]
    assert st["calls"] == 1 and float(st["max_abs_err"]) == 0.0 and st["refereed"] == 0
    assert list(st["shapes"].values()) == [1]


@pytest.mark.parametrize("switched, levers, frame_kernels", [
    (False, {}, set()),
    (True, {}, {"fused_glimpse_bwd", "fused_prop_bwd"}),
    (True, chip_smoke.DISC_LEVERS, {"fused_prop_bwd", "fused_disc_bwd"})],
    ids=["off", "both", "both_disc"])
def test_every_backward_call_of_a_train_step_is_held(monkeypatch, switched, levers,
                                                    frame_kernels):
    """The two-rank data-parallel steps' gate, on a train step of a small
    release model: inside ``checked_bwd_calls(frames=True)`` every backward
    wrapper call the step makes, with the wrappers' own keywords, is held
    and counted, as many as ``expected_launches`` says; with both switches
    the glimpse and propagation backwards (discovery unfused, as at the
    release flags) or, at DISC_FLAGS, the propagation and discovery ones."""
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.ops.noise import GeneratorNoise
    from torch_parity import B, H, S, T, golden_batch

    for name in ("SQAIR_FUSE_GLIMPSE", "SQAIR_FUSE_CELLS"):
        if switched:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)
    flags = dict(dict(n_units=1, n_what=8, n_steps_per_image=S, glimpse_size=8,
                      k_particles=2, early_disc_logit_scale=0.15, transient_disc_penalty=2.0),
                 **levers)
    model = mlp_mnist_model.load(flags, (H, H), device="cpu", seed=0)
    obs, nums = golden_batch()
    with chip_smoke.checked_bwd_calls(torch, "test", frames=True) as report:
        target, _ = model.loss_and_metrics(
            torch.from_numpy(obs), GeneratorNoise(torch.Generator().manual_seed(1), "cpu"),
            torch.from_numpy(nums), record_mode="train")
        target.backward()
    shapes = chip_smoke.main_path_shapes(flags, B, 2, T, train=True, img=(H, H),
                                         fuse_glimpse=switched, fuse_cells=switched)
    want = {k: n for k, n in chip_smoke.expected_launches(shapes, 1, backward=True).items()
            if k.endswith("_bwd")}
    assert {k: st["calls"] for k, st in report.items()} == want
    assert all(float(st["max_abs_err"]) == 0.0 for st in report.values())
    assert set(report) - set(chip_smoke.BWD_KERNELS) == frame_kernels
