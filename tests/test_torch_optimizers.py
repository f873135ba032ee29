"""The port's adam, sgd and momentum (sqair_tpu_torch/training/train.py)
held to the JAX package's optax optimizers (sqair_tpu/training/train.py
``make_optimizer``) over three updates across a schedule boundary; the
coverage-row wrapper held to ``scale_coverage_row_updates``, its optimizer
state the inner optimizer's; each optimizer's step on a device-tensor rate
(what a captured graph reads) giving the host step's bits; and each
optimizer's state through a checkpoint and back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sqair_tpu.training.train import make_lr_schedule as jax_make_lr_schedule
from sqair_tpu.training.train import make_optimizer as jax_make_optimizer
from sqair_tpu.training.train import scale_coverage_row_updates as jax_scale_rows
from sqair_tpu_torch.training import (is_disc_steps_kernel, make_lr_schedule, make_optimizer,
                                      scale_coverage_row_updates)
from sqair_tpu_torch.training.checkpoint import restore_train_state, save_checkpoint
from sqair_tpu_torch.training.train import TrainState
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

NAMES = ("adam", "sgd", "momentum", "rmsprop")
# a parameter tree with the discovery and the propagation steps predictors'
# first-layer kernels (the wrapper scales the first's last rows only)
SHAPES = {
    "timestep.discover.cell.steps_predictor.MLP_0.w_0": (20, 4),
    "timestep.discover.cell.steps_predictor.MLP_0.b_0": (4,),
    "timestep.propagate.ssm_cell.steps_predictor.MLP_0.w_0": (20, 4),
    "decoder.output_scale": (),
}
TRAIN_ITR = 10  # the "4,6,10" schedule's first boundary at count 2


def _nest(flat):
    """{'a.b.c': x} -> {'a': {'b': {'c': x}}}."""
    out = {}
    for name, v in flat.items():
        node = out
        keys = name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {".".join(prefix): np.asarray(tree)}


def _problem(seed=0, steps=3):
    rs = np.random.default_rng(seed)
    params = {k: np.asarray(rs.standard_normal(s), np.float32) for k, s in SHAPES.items()}
    grads = [{k: np.asarray(rs.standard_normal(s) * 10 ** rs.uniform(-2, 1), np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_jax(jopt, params, grads):
    jparams = _nest({k: jnp.asarray(v) for k, v in params.items()})
    state = jopt.init(jparams)
    for g in grads:
        upd, state = jopt.update(_nest({k: jnp.asarray(v) for k, v in g.items()}), state,
                                 jparams)
        jparams = optax.apply_updates(jparams, upd)
    return _flat(jparams), state


def _run_port(factory, params, grads, wrap=None):
    """(parameters after the updates, the optimizer, the parameter tensors);
    ``wrap(factory, named tensors)`` wraps the factory first."""
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    if wrap is not None:
        factory = wrap(factory, tparams.items())
    opt = factory(list(tparams.values()))
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    return {k: p.detach().numpy() for k, p in tparams.items()}, opt, tparams


def _close(got, want, what, tol=1e-6):
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.max(np.abs(got[k] - w)) / max(np.max(np.abs(w)), 1e-30)
        assert err <= tol, f"{what} {k}: {err:.3g}"


@pytest.mark.parametrize("name", ["adam", "sgd", "momentum"])
def test_optimizer_matches_optax_across_a_schedule_boundary(name):
    params, grads = _problem()
    want, _ = _run_jax(jax_make_optimizer(name, jax_make_lr_schedule(0.05, "4,6,10", TRAIN_ITR)),
                       params, grads)
    got, opt, _ = _run_port(make_optimizer(name, make_lr_schedule(0.05, "4,6,10", TRAIN_ITR)),
                            params, grads)
    assert opt.count == 3
    # the parameters moved, by more than the rounding
    assert all(np.max(np.abs(got[k] - params[k])) > 1e-4 for k in params)
    _close(got, want, name)


@pytest.mark.parametrize("name", NAMES)
def test_coverage_row_wrapper_matches_jax_and_keeps_the_state(name):
    """The last 16 rows of the discovery steps predictor's w_0 move by mult
    times the inner optimizer's update; the state is the unwrapped one's."""
    mult, lr = 10.0, make_lr_schedule(0.05, "4,6,10", TRAIN_ITR)
    params, grads = _problem(seed=1)
    want, _ = _run_jax(jax_scale_rows(jax_make_optimizer(
        name, jax_make_lr_schedule(0.05, "4,6,10", TRAIN_ITR)), mult), params, grads)
    got, opt, tparams = _run_port(make_optimizer(name, lr), params, grads, wrap=lambda f, named:
                                  scale_coverage_row_updates(f, mult, named))
    _close(got, want, f"{name} wrapped")
    plain, inner, iparams = _run_port(make_optimizer(name, lr), params, grads)
    kernel = "timestep.discover.cell.steps_predictor.MLP_0.w_0"
    assert [k for k in params if is_disc_steps_kernel(k)] == [kernel]
    for k in params:
        same = np.array_equal(got[k], plain[k])
        assert same == (k != kernel), k
    assert np.array_equal(got[kernel][:-16], plain[kernel][:-16])
    for k in params:
        for slot in opt.STATE:
            assert torch.equal(opt.state[tparams[k]][slot], inner.state[iparams[k]][slot]), \
                (k, slot)
    # a tree without the discovery steps predictor's kernel: nothing scaled
    other = {k: v for k, v in params.items() if k != kernel}
    got, _, _ = _run_port(make_optimizer(name, lr), other, [
        {k: v for k, v in g.items() if k != kernel} for g in grads],
        wrap=lambda f, named: scale_coverage_row_updates(f, mult, named))
    for k in other:
        assert np.array_equal(got[k], plain[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_step_on_a_tensor_rate_gives_the_same_bits(name):
    """step(lr=t), t the float32 numbers ``scalars_at`` gives (what a
    captured CUDA graph reads), against step() over 4 updates across the
    boundary."""
    params, grads = _problem(seed=2, steps=4)
    lr = make_lr_schedule(0.05, "4,6,10", TRAIN_ITR)
    want, _, _ = _run_port(make_optimizer(name, lr), params, grads)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_optimizer(name, lr)(list(tparams.values()))
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        scalars = torch.tensor(opt.scalars_at(lr, opt.count), dtype=torch.float32)
        opt.step(lr=scalars)
    for k, p in tparams.items():
        assert np.array_equal(p.detach().numpy(), want[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_state_round_trips_a_checkpoint(name, tmp_path):
    params, grads = _problem(seed=3)
    lr = make_lr_schedule(0.05, "4,6,10", TRAIN_ITR)
    seq = torch.nn.Module()
    for k, v in params.items():
        seq.register_parameter(k.replace(".", "_"), torch.nn.Parameter(torch.from_numpy(v)))
    named = list(seq.named_parameters())
    opt = make_optimizer(name, lr)([p for _, p in named])
    for g in grads[:2]:
        for (n, p), k in zip(named, params):
            p.grad = torch.from_numpy(g[k])
        opt.step()
    path = save_checkpoint(str(tmp_path), 2, seq, opt)
    seq2 = torch.nn.Module()
    for n, p in named:
        seq2.register_parameter(n, torch.nn.Parameter(torch.zeros_like(p)))
    opt2 = make_optimizer(name, lr)(list(seq2.parameters()))
    restore_train_state(path, seq2, TrainState(opt2))
    assert opt2.count == 2
    for (n, p), (_, p2) in zip(named, seq2.named_parameters()):
        assert torch.equal(p, p2)
        for slot in opt.STATE:
            assert torch.equal(opt.state[p][slot], opt2.state[p2][slot]), (n, slot)
    # one more step from either gives the same bits
    for (_, p), (_, p2), k in zip(named, seq2.named_parameters(), params):
        p.grad = p2.grad = torch.from_numpy(grads[2][k])
    opt.step()
    opt2.step()
    for (_, p), (_, p2) in zip(named, seq2.named_parameters()):
        assert torch.equal(p, p2)
    other = "sgd" if name != "sgd" else "adam"
    opt3 = make_optimizer(other, lr)(list(seq2.parameters()))
    with pytest.raises(KeyError, match="optimizer state"):
        restore_train_state(path, seq2, TrainState(opt3))
