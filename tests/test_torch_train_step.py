"""The training step of sqair_tpu_torch held to sqair_tpu's: the TF-style
RMSProp and its schedule against optax, three whole train steps against
``make_train_step``, the L2 penalty, the training flags and the
device-resident sampler.

Tolerances, with why:
- the optimizer alone: every parameter within 1e-6 of its largest element
  after each update (the same f32 operations in the same order; rsqrt
  differs in the last bit, which an element near 0 carries);
- three train steps: after step i, every element of a parameter within
  sum_j lr EPS max|g_j| / sqrt(0.9) w_ij of JAX's, plus 4 f32 ulps of the
  parameter's largest element (each side rounds p + m once per step).  Here
  max|g_j| is the largest |gradient| of the parameter at step j (read off
  JAX's optimizer state), w_ij the momentum's weight of step j's update after
  step i, and EPS = 3e-4: the whole step's gradients agree to ~1e-4 of their
  largest entry (tests/test_torch_train_grads.py; up to 1.2e-4 with these
  draws), and RMSProp divides each element's gradient by its own root mean
  square (>= sqrt(0.9) in the first steps), so a small element's step carries
  the rounding of the parameter's largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sqair_tpu.models import Model as JModel
from sqair_tpu.models import SequentialAIR as JSequentialAIR
from sqair_tpu.ops import targets as jtargets
from sqair_tpu.training import make_lr_schedule as jax_make_lr_schedule
from sqair_tpu.training import make_optimizer as jax_make_optimizer
from sqair_tpu.training import make_train_step as jax_make_train_step
from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.convert import load_flax_params, params_from_flax
from sqair_tpu_torch.data import DeviceDatasetSampler, create_seq_dataset, make_template_bank
from sqair_tpu_torch.models import Model
from sqair_tpu_torch.ops import targets
from sqair_tpu_torch.ops.noise import ReplayNoise
from sqair_tpu_torch.training import make_lr_schedule, make_optimizer, make_train_step
from torch_parity import (B, NWHAT, S, T, build_pair, golden_batch, jax_noise_table, to_numpy,
                          tpu_kernels_interpreted)
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

N_STEPS = 3
# at lr 1e-3 the first RMSProp steps (nu starts at 1) move weights of ~0.2 by
# up to ~0.05 and the golden model's loss climbs; the third step's gradients
# then differ by up to 1e-2 of their largest entry between any two f32 runs,
# though each step's gradients agree to ~1e-4 when both start from the same
# parameters.  At 1e-4 they agree to ~1e-4 at every step.
LR = 1e-4
L2 = 1e-3
EPS = 3e-4  # gradient agreement assumed per step, as a share of the largest |g|


def test_rmsprop_and_schedule_match_optax():
    """20 updates on fixed random gradients, with a schedule whose
    boundaries (4 and 10) fall inside the run."""
    rs = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": ()}
    params = {k: np.asarray(rs.standard_normal(s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rs.standard_normal(s) * 10 ** rs.uniform(-3, 1), np.float32)
              for k, s in shapes.items()} for _ in range(20)]

    jopt = jax_make_optimizer("rmsprop", jax_make_lr_schedule(0.05, "4,6,10", 20))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jparams)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_optimizer("rmsprop", make_lr_schedule(0.05, "4,6,10", 20))(
        list(tparams.values()))
    for i, g in enumerate(grads):
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            want = np.asarray(jparams[k], np.float64)
            err = np.max(np.abs(p.detach().numpy() - want)) / np.max(np.abs(want))
            assert err <= 1e-6, f"update {i}, {k}: {err:.3g}"


def test_rmsprop_eps_inside_the_root_matches_optax():
    """After 230 zero gradients the mean square has decayed to ~1e-11, below
    eps = 1e-10, so only eps inside the root (rsqrt(nu + eps)) gives optax's
    step for the small gradients that follow."""
    grads = [np.zeros(3, np.float32)] * 230 + [np.asarray([1e-6, -2e-6, 5e-7], np.float32)] * 3
    jopt = jax_make_optimizer("rmsprop", 0.01)
    jp = jnp.ones(3)
    state = jopt.init(jp)
    p = torch.ones(3, requires_grad=True)
    opt = make_optimizer("rmsprop", 0.01)([p])
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        opt.step()
    moved = np.abs(np.asarray(jp) - 1.0)
    assert moved.min() > 1e-4  # the last steps moved the parameters
    np.testing.assert_allclose(p.detach().numpy() - 1.0, np.asarray(jp) - 1.0, rtol=1e-4)


def test_schedule_boundaries():
    rate = make_lr_schedule(1.0, "4,6,10", 1000)
    assert [rate(c) for c in (0, 199, 200, 499, 500, 999)] == [
        1.0, 1.0, 1 / 3, 1 / 3, 1 / 9, 1 / 9]
    assert make_lr_schedule(0.5, "", 10) == 0.5
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer("adagrad", 1e-3)


def test_l2_reg_matches_jax():
    rs = np.random.default_rng(1)
    arrays = [rs.standard_normal(s).astype(np.float32) for s in ((3, 4), (4,), ())]
    ps = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = targets.l2_reg(ps, 0.3)
    got.backward()
    want, jgrads = jax.value_and_grad(lambda p: jtargets.l2_reg(p, 0.3))(
        [jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for p, g in zip(ps, jgrads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-6)
    assert float(targets.l2_reg(ps, 0.0)) == 0.0


def test_training_flags_of_the_release_model():
    flags = dict(opt="rmsprop", learning_rate=1e-5, schedule="4,6,10", train_itr=1000000,
                 l2=0.0)
    assert mlp_mnist_model.train_settings(flags) == flags
    factory, l2 = mlp_mnist_model.make_optimizer(flags)
    opt = factory([torch.zeros(2, requires_grad=True)])
    assert l2 == 0.0 and opt.rate(opt.param_groups[0]["lr"]) == 1e-5
    opt.count = 200000  # boundaries at 200000 and 500000
    assert opt.rate(opt.param_groups[0]["lr"]) == pytest.approx(1e-5 / 3)
    opt.count = 500000
    assert opt.rate(opt.param_groups[0]["lr"]) == pytest.approx(1e-5 / 9)
    assert mlp_mnist_model.train_settings(dict(opt="adam"))["opt"] == "adam"
    with pytest.raises(ValueError, match="Unknown optimizer"):
        mlp_mnist_model.train_settings(dict(opt="adagrad"))


def test_train_steps_match_jax():
    """Three RMSProp steps (lr 1e-4) of the whole train step at the golden
    config (k=5, the release model's levers, an L2 weight), each with its own rng
    and that rng's noise, against sqair_tpu's make_train_step on its TPU
    kernels (interpreted)."""
    k = 5
    model_kw = dict(transient_penalty=400.0)
    jts, jdec, seq = build_pair(early_disc_logit_scale=0.15)
    jmodel = JModel(JSequentialAIR(jts, jdec), k_particles=k, **model_kw)
    obs, nums = golden_batch()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    model = Model(load_flax_params(seq, to_numpy(params)), k_particles=k, **model_kw)

    jopt = jax_make_optimizer("rmsprop", LR)
    jstep = jax_make_train_step(jmodel, jopt, l2_weight=L2, donate=False)
    jstate = jopt.init(params)
    step = make_train_step(model, make_optimizer("rmsprop", LR), l2_weight=L2)
    trace_prev = {n: np.zeros(p.shape) for n, p in seq.named_parameters()}
    step_bounds = {n: [] for n in trace_prev}
    with tpu_kernels_interpreted():
        for i in range(N_STEPS):
            rng = jax.random.fold_in(jax.random.PRNGKey(7), i)
            params, jstate, jmetrics = jstep(params, jstate, rng, jnp.asarray(obs),
                                             jnp.asarray(nums))
            metrics = step(obs, nums, ReplayNoise(jax_noise_table(rng, T, S, B * k, NWHAT),
                                                  "cpu"))
            np.testing.assert_allclose(float(metrics["target"]), float(jmetrics["target"]),
                                       rtol=1e-4)
            want = params_from_flax(to_numpy(params))
            nu = params_from_flax(to_numpy(jstate[0].nu))
            trace = params_from_flax(to_numpy(jstate[2].trace))
            # the momentum's weight of step j's update in the position after step i
            weights = [sum(0.9**m for m in range(i - j + 1)) for j in range(i + 1)]
            for name, p in seq.named_parameters():
                # JAX's gradient of this step, from its optimizer state:
                # u_i = m_i - 0.9 m_{i-1} = -lr g_i / sqrt(nu_i + eps)
                m_i = trace[name].numpy().astype(np.float64)
                u_i = m_i - 0.9 * trace_prev[name]
                trace_prev[name] = m_i
                g = -u_i * np.sqrt(nu[name].numpy().astype(np.float64) + 1e-10) / LR
                g_max = float(np.max(np.abs(g), initial=0))
                step_bounds[name].append(LR * EPS * g_max / np.sqrt(0.9))
                tol = sum(b * w for b, w in zip(step_bounds[name], weights))
                w = want[name].numpy().astype(np.float64)
                tol += 4 * np.finfo(np.float32).eps * float(np.max(np.abs(w), initial=0))
                err = float(np.max(np.abs(p.detach().numpy() - w), initial=0))
                assert err <= tol, f"step {i} {name}: {err:.3g} > {tol:.3g}"
    assert step.state.step == N_STEPS


def test_device_sampler_shapes_range_and_repeatability():
    data = create_seq_dataset(n_samples=12, n_timesteps=4, canvas_size=(24, 24),
                              obj_size=(8, 8), n_objects=(0, 2), seed=3,
                              templates=make_template_bank(16, 8, seed=0))
    sampler = DeviceDatasetSampler(data, "cpu")
    assert sampler.imgs.dtype == torch.uint8 and sampler.imgs.shape == (12, 4, 24, 24)
    a = sampler.sample(torch.Generator().manual_seed(5), 6)
    b = sampler.sample(torch.Generator().manual_seed(5), 6)
    assert a["imgs"].shape == (4, 6, 24, 24) and a["imgs"].dtype == torch.float32
    assert a["nums"].shape == (4, 6, 3) and a["nums"].dtype == torch.float32
    assert float(a["imgs"].min()) >= 0.0 and float(a["imgs"].max()) <= 1.0
    assert torch.equal(a["imgs"], b["imgs"]) and torch.equal(a["nums"], b["nums"])
    # every drawn sequence is one of the dataset's, frame for frame
    imgs = torch.from_numpy(data["imgs"]).to(torch.float32) / 255.0  # [T, N, H, W]
    for j in range(6):
        assert any(torch.equal(a["imgs"][:, j], imgs[:, i]) for i in range(12))
    c = sampler.sample(torch.Generator().manual_seed(6), 6)
    assert not torch.equal(a["imgs"], c["imgs"])
