"""The plain reference against the program's plain path at a tiny size on
the CPU, and the yardstick's FLOP count against PyTorch's counter."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from helpers import tiny_cell, tiny_config
from harness import weights, yardstick
from reference import train as reference_train
from reference.build import build_model
from reference.nn import layers
from reference.ops.noise import TableNoise

IMG = (26, 26)
B, T = 2, 4


def models(name):
    from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model

    cfg = tiny_config(name)
    mean = np.linspace(0.0, 0.2, IMG[0] * IMG[1], dtype=np.float32).reshape(IMG)
    w = weights.make(cfg, mean, torch.Generator().manual_seed(11))
    loader = conv_mnist_model if cfg["model"] == "conv" else mlp_mnist_model
    program = loader.load(cfg["flags"], IMG, mean_img=mean, device="cpu")
    weights.load(program.sequence, w)
    reference = build_model(cfg["model"], cfg["flags"], IMG, "cpu", mean)
    weights.load(reference.sequence, w)
    return cfg, program, reference, w


@pytest.mark.parametrize("name", ["mlp_release", "conv_mnist"])
def test_reference_step_matches_the_programs_plain_path(name):
    """One train step: the loss, every gradient and the weights after
    RMSProp, from the same weights, batch and noise."""
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.ops.noise import GeneratorNoise
    from sqair_tpu_torch.training import make_train_step

    cfg, program, reference, _ = models(name)
    g = torch.Generator().manual_seed(4)
    batch = dict(imgs=torch.rand((T, B) + IMG, generator=g),
                 nums=torch.tensor([1.0, 1.0, 0.0]).expand(T, B, 3).clone())
    noise = GeneratorNoise(torch.Generator().manual_seed(5), "cpu", record=True)
    factory, l2 = mlp_mnist_model.make_optimizer(cfg["flags"])
    step = make_train_step(program, factory, l2)
    # the program's gradients, from the same draws, before its update
    target, _ = program.loss_and_metrics(batch["imgs"], noise, batch["nums"],
                                         l2_weight=l2, record_mode="train")
    target.backward()
    grads = {n: p.grad.clone() for n, p in program.sequence.named_parameters()
             if p.grad is not None}
    for p in program.sequence.parameters():
        p.grad = None
    metrics = step(batch["imgs"], batch["nums"], TableNoise(noise.table))
    ref = reference_train.follow(reference, cfg["flags"], [batch], [TableNoise(noise.table)])

    assert abs(float(metrics["target"]) - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    assert sorted(grads) == sorted(ref["grads"])
    for n, g_ref in ref["grads"].items():
        scale = float(g_ref.abs().max()) + 1e-6
        assert float((grads[n] - g_ref).abs().max()) <= 1e-3 * scale, n
    for n, p in program.sequence.named_parameters():
        moved = ref["params"][n]
        assert torch.allclose(p.detach(), moved, rtol=0, atol=1e-7 + 1e-6 * float(moved.abs().max())), n


@pytest.mark.parametrize("name", ["mlp_release", "conv_mnist"])
def test_flops_agree_with_the_flop_counter(name):
    """The yardstick's forward products of every dense layer, cell and
    convolution equal what ``FlopCounterMode`` counts in those modules of
    the reference's train-record forward."""
    from sqair_tpu_torch.ops.noise import GeneratorNoise

    cfg, _, reference, _ = models(name)
    counter = FlopCounterMode(display=False)
    with counter:
        reference.loss_and_metrics(torch.rand((T, B) + IMG),
                                   GeneratorNoise(torch.Generator().manual_seed(5), "cpu"),
                                   torch.ones((T, B, 4)), record_mode="train")
    counts = counter.get_flop_counts()
    root = type(reference.sequence).__name__

    def counted(kinds):
        return sum(sum(counts.get(f"{root}.{n}", {}).values())
                   for n, m in reference.sequence.named_modules() if isinstance(m, kinds))

    mine = yardstick.model_flops(cfg["flags"], cfg["model"] == "conv", B,
                                 cfg["flags"]["k_particles"], T, IMG)
    assert mine["dense"] == counted((layers.MLP, layers.Dense, layers.VanillaRNN, layers.GRU))
    assert mine["conv"] == counted((layers.Conv,))
    assert mine["conv"] > 0 if cfg["model"] == "conv" else mine["conv"] == 0
    assert yardstick.train_step_flops(cfg["flags"], cfg["model"] == "conv", B,
                                      cfg["flags"]["k_particles"], T, IMG) == 3 * sum(mine.values())


def test_trace_gives_back_the_first_gradient():
    """RMSProp's trace and mean square after one step, in float32, give the
    gradient back to float32's rounding, a large one as well as a small
    one (the trace alone saturates at sqrt(10) lr for a large one)."""
    from harness import oracle

    g = torch.tensor([-3.0, -1e-4, 0.0, 2e-6, 0.5, 40.0, -2e3, 7e5])
    lr = 1e-5
    nu = 0.9 * torch.ones_like(g) + 0.1 * g * g
    trace = -lr * g * torch.rsqrt(nu + 1e-10)
    assert torch.allclose(oracle.gradient_from_state(trace, nu, lr), g.double(), rtol=1e-6,
                          atol=0)


def test_look_pairs_the_program_and_both_references():
    """``look.py`` at a tiny size on the CPU (float64 convolutions have no
    CPU weight gradient, so the MLP cell): each pair of runs from the same
    start agrees to rounding, no presence draw parts, and the program's
    plain path gives the float64 reference's first gradient."""
    import look

    out = look.look(tiny_cell("mlp_release-train-fused"), 2**31 + 77, "cpu", True)
    for pair in out["pairs"].values():
        assert pair["grad"] < 1e-4 and pair["change"] < 1e-4, pair
    assert all(p[k]["differ"] == 0 for p in out["presence"]
               for k in ("program_f32", "program_f64", "f32_f64"))
    assert out["cpu"]["grad"] < 1e-4
