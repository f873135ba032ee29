"""The chained train step (sqair_tpu_torch/training/graph.py) and the
device-tensor learning rate it reads.

On the CPU: the chain's steps give make_train_step's bits over a schedule
boundary inside one call (the rate read from a float32 tensor, f32(rate),
against the host float, which the update rounds to f32 too), and
``TrainSnapshot`` puts the state back in place.  On the card (the ``cuda``
marker; skips without one, and imports no JAX: run it with ``python -m
pytest tests/test_torch_graph.py -m cuda --noconftest``): a captured
two-step chain, replayed, against the same steps run eagerly, and its
launch counts.  Bits: the same kernels on the same inputs; no tolerance.
"""
import numpy as np
import pytest
import torch

from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.data import DeviceDatasetSampler, create_seq_dataset, make_template_bank
from sqair_tpu_torch.ops import fused
from sqair_tpu_torch.ops.noise import GeneratorNoise
from sqair_tpu_torch.training import init_train, make_optimizer, make_train_step
from sqair_tpu_torch.training.graph import TrainSnapshot, make_chained_train_step

# boundaries of "4,6,10" over 8 steps: 2 and 4
FLAGS = dict(n_units=2, k_particles=2, learning_rate=1e-3, schedule="4,6,10", train_itr=8,
             early_disc_logit_scale=0.15, transient_disc_penalty=400.0)
B, T = 4, 2


@pytest.fixture(scope="module")
def data():
    d = create_seq_dataset(n_samples=16, n_timesteps=3, canvas_size=(50, 50),
                           obj_size=(28, 28), seed=0, templates=make_template_bank(32, 28, 0))
    d["imgs"] = d["imgs"].astype(np.float32) / 255.0
    return d


def _model(data, device, flags=FLAGS):
    return mlp_mnist_model.load(flags, (50, 50), mean_img=data["imgs"].mean((0, 1)),
                                device=device)


def _eager_then_chained(data, device, chain_steps, calls, flags=FLAGS):
    """(eager model, its last metrics, chained model, its last metrics,
    chain): chain_steps x calls steps each, from the same weights, seeds and
    sampler."""
    sampler = DeviceDatasetSampler(data, device)
    factory, l2 = mlp_mnist_model.make_optimizer(flags)
    eager = _model(data, device, flags)
    step = make_train_step(eager, factory, l2)
    g_data = torch.Generator(device=device).manual_seed(0)
    g_noise = torch.Generator(device=device).manual_seed(2)
    for _ in range(chain_steps * calls):
        b = sampler.sample(g_data, B)
        m_eager = step(b["imgs"][:T], b["nums"][:T], GeneratorNoise(g_noise, device))
    chained = _model(data, device, flags)
    state = init_train(chained, factory)
    h_data = torch.Generator(device=device).manual_seed(0)
    h_noise = torch.Generator(device=device).manual_seed(2)
    chain = make_chained_train_step(chained, state, lambda: sampler.sample(h_data, B),
                                    chain_steps, T, l2,
                                    lambda itr: GeneratorNoise(h_noise, device),
                                    [h_data, h_noise])
    for _ in range(calls):
        m_chain = {k: v.clone() for k, v in chain().items()}
    assert state.step == state.optimizer.count == chain_steps * calls
    return eager, m_eager, chained, m_chain, chain


def _assert_same(eager, m_eager, chained, m_chain):
    for (name, a), b in zip(eager.sequence.named_parameters(), chained.sequence.parameters()):
        assert torch.equal(a, b), name
    assert m_eager.keys() == m_chain.keys()
    for k in m_eager:
        assert torch.equal(m_eager[k], m_chain[k]), k


def test_tensor_rate_gives_the_host_floats_bits():
    """TFRMSProp.step(lr=f32 tensor) against step() over 6 updates on fixed
    gradients, a schedule boundary at 2 and 4, rates that f32 cannot hold."""
    rs = np.random.default_rng(0)
    init = rs.standard_normal((5, 3)).astype(np.float32)
    grads = [rs.standard_normal((5, 3)).astype(np.float32) for _ in range(6)]
    schedule = lambda c: 0.1 * (1 / 3) ** ((c >= 2) + (c >= 4))  # noqa: E731
    a, b = torch.tensor(init, requires_grad=True), torch.tensor(init, requires_grad=True)
    opt_a, opt_b = make_optimizer("rmsprop", schedule)([a]), make_optimizer("rmsprop", schedule)([b])
    for i, g in enumerate(grads):
        a.grad, b.grad = torch.from_numpy(g), torch.from_numpy(g)
        opt_a.step()
        opt_b.step(lr=torch.tensor(schedule(i), dtype=torch.float32))
        assert torch.equal(a, b), f"update {i}"


def test_chain_over_a_schedule_boundary_matches_eager_steps(data):
    """One chained call of 4 steps (boundaries at 2 and 4: the rate moves
    inside the call) against 4 make_train_step steps: the same bits."""
    _assert_same(*_eager_then_chained(data, "cpu", 4, 1)[:4])


def test_snapshot_restores_in_place(data):
    model = _model(data, "cpu")
    factory, _ = mlp_mnist_model.make_optimizer(FLAGS)
    state = init_train(model, factory)
    p0 = next(model.sequence.parameters())
    gen = torch.Generator().manual_seed(5)
    snap = TrainSnapshot(model, state, [gen])
    before, ptr, gstate = p0.detach().clone(), p0.data_ptr(), gen.get_state()
    p0.grad = torch.ones_like(p0)
    state.optimizer.step()  # makes the optimizer's state and counts
    state.step += 1
    nu = state.optimizer.state[p0]["nu"]
    torch.rand(3, generator=gen)
    snap.restore()
    assert torch.equal(p0, before) and p0.data_ptr() == ptr and p0.grad is None
    assert state.optimizer.count == 0 and state.step == 0
    assert state.optimizer.state[p0]["nu"] is nu and torch.equal(nu, torch.ones_like(nu))
    assert torch.equal(state.optimizer.state[p0]["trace"], torch.zeros_like(p0))
    assert torch.equal(gen.get_state(), gstate)


@pytest.mark.cuda
def test_captured_chain_replays_the_eager_steps_on_cuda(data):
    """A two-step chain captured once and replayed twice against 4 eager
    steps on the card (skips without one): the same parameters and last
    metrics, and a capture launches twice what one eager step does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fused.reset_launches()
    step_model = _model(data, "cuda")
    factory, l2 = mlp_mnist_model.make_optimizer(FLAGS)
    sampler = DeviceDatasetSampler(data, "cuda")
    step = make_train_step(step_model, factory, l2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = sampler.sample(gen, B)
    step(b["imgs"][:T], b["nums"][:T], GeneratorNoise(gen, "cuda"))
    torch.cuda.synchronize()
    one_step = dict(fused.launches)
    eager, m_eager, chained, m_chain, chain = _eager_then_chained(data, "cuda", 2, 2)
    _assert_same(eager, m_eager, chained, m_chain)
    assert chain.graph is not None
    assert chain.launches == {k: 2 * v for k, v in one_step.items()}
