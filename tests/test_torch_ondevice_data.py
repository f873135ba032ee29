"""The on-device data pipeline of sqair_tpu_torch held to sqair_tpu's: the
ST / pixel box conversions (``ops/stn.py``), the device trajectory
(``data/trajectory.py:noisy_acceleration`` against ``jax_noisy_acceleration``)
and ``OnDeviceSeqMNIST.render`` against JAX's ``OnDeviceSeqMNIST.__call__``.

jax.random's draws cannot be made with torch, so the tests draw them with
the same ``jax.random.split`` sequence as the JAX code and pass them to the
port as arrays.  Tolerances: 1e-6 absolute for the box conversions (a few
float32 operations on values of order 1-60: a few ulps), 1e-5 absolute for
the trajectories (positions up to ~40 pixels after up to 7 float32 steps)
and the rendered frames (in [0, 1]), as the port's other data checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqair_tpu.data import OnDeviceDatasetSampler as JSampler
from sqair_tpu.data import OnDeviceSeqMNIST as JOnDeviceSeqMNIST
from sqair_tpu.data.trajectory import jax_noisy_acceleration
from sqair_tpu.ops import stn as jstn
from sqair_tpu_torch.data import (DeviceDatasetSampler, OnDeviceSeqMNIST, draw_noisy_acceleration,
                                  make_template_bank, noisy_acceleration)
from sqair_tpu_torch.ops import stn
from torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)

MAX_SPEED, MAX_ACC, NOISE_STD = 10.0, 3.0, 0.01


def _jax_trajectory_draws(rng, n_timesteps, n):
    """jax_noisy_acceleration's draws for key ``rng``, as numpy arrays."""
    r_vel, r_acc, r_noise = jax.random.split(rng, 3)
    vel = jax.random.uniform(r_vel, (n, 2), minval=-MAX_SPEED, maxval=MAX_SPEED)
    acc = jax.random.uniform(r_acc, (n, 2), minval=-MAX_ACC, maxval=MAX_ACC)
    noise = [jax.random.normal(r, (n, 2)) for r in jax.random.split(r_noise, n_timesteps - 1)]
    return dict(vel=np.array(vel), acc=np.array(acc), noise=np.stack(noise))


def _jax_render_draws(gen, rng, batch_size):
    """JAX's OnDeviceSeqMNIST.__call__ draws for key ``rng``, keyed as the
    port's ``OnDeviceSeqMNIST.draw`` returns them."""
    T, (H, W) = gen.n_timesteps, gen.canvas_size
    th, tw = gen.templates.shape[1:3]
    M = max(gen.max_obj, 1)
    r_n, r_idx, r_pos, r_tj = jax.random.split(rng, 4)
    nums = jax.random.randint(r_n, (batch_size,), gen.min_obj, gen.max_obj + 1)
    idx = jax.random.randint(r_idx, (batch_size, M), 0, gen.templates.shape[0])
    init_pos = jax.random.uniform(r_pos, (batch_size * M, 2), minval=jnp.zeros(2),
                                  maxval=jnp.asarray([H - th, W - tw], jnp.float32))
    return dict(nums=np.array(nums), idx=np.array(idx), init_pos=np.array(init_pos),
                **_jax_trajectory_draws(r_tj, T, batch_size * M))


@pytest.mark.parametrize("img_size", [(50, 50), (64, 48)])
def test_box_conversions_match_jax(img_size):
    rs = np.random.default_rng(0)
    coords = np.concatenate([rs.uniform(0.05, 1.0, (7, 3, 2)), rs.uniform(-1, 1, (7, 3, 2))],
                            -1).astype(np.float32)
    boxes = np.concatenate([rs.uniform(-5, 40, (7, 3, 2)), rs.uniform(1, 40, (7, 3, 2))],
                           -1).astype(np.float32)
    got = stn.stn_to_pixel_coords(torch.from_numpy(coords), img_size).numpy()
    np.testing.assert_allclose(got, np.asarray(jstn.stn_to_pixel_coords(coords, img_size)),
                               rtol=0, atol=1e-6)
    got = stn.pixel_to_stn_coords(torch.from_numpy(boxes), img_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jstn.pixel_to_stn_coords(boxes, img_size)),
                               rtol=0, atol=1e-6)
    # and back
    np.testing.assert_allclose(stn.stn_to_pixel_coords(got, img_size).numpy(), boxes, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_trajectory_matches_jax(seed):
    n, T = 64, 8
    rng_pos, rng_tj = jax.random.split(jax.random.PRNGKey(seed))
    bounds = [[0.0, 22.0], [0.0, 36.0]]
    init_pos = np.array(jax.random.uniform(rng_pos, (n, 2), maxval=jnp.asarray([22.0, 36.0])))
    want = jax_noisy_acceleration(rng_tj, T, init_pos, bounds, MAX_SPEED, MAX_ACC, NOISE_STD)
    draws = {k: torch.from_numpy(v) for k, v in _jax_trajectory_draws(rng_tj, T, n).items()}
    got = noisy_acceleration(torch.from_numpy(init_pos), draws["vel"], draws["acc"],
                             draws["noise"], bounds, MAX_SPEED, MAX_ACC, NOISE_STD)
    assert got.shape == (T, n, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # some trajectories bounced (turned around), and the positions stay inside
    step = got[1:] - got[:-1]
    assert (step[1:] * step[:-1] < 0).any()
    assert float(got[..., 0].min()) >= 0 and float(got[..., 0].max()) <= 22.0
    assert float(got[..., 1].min()) >= 0 and float(got[..., 1].max()) <= 36.0


def test_trajectory_draws_have_the_jax_ranges():
    d = draw_noisy_acceleration(torch.Generator().manual_seed(0), 10, 500, MAX_SPEED, MAX_ACC)
    assert d["vel"].shape == d["acc"].shape == (500, 2) and d["noise"].shape == (9, 500, 2)
    assert float(d["vel"].abs().max()) <= MAX_SPEED and float(d["vel"].abs().max()) > 9.0
    assert float(d["acc"].abs().max()) <= MAX_ACC and float(d["acc"].abs().max()) > 2.7
    assert abs(float(d["noise"].std()) - 1.0) < 0.05


@pytest.mark.parametrize("canvas,n_objects", [((50, 50), (0, 2)), ((64, 48), (1, 3)),
                                              ((50, 50), (0, 0))])
def test_render_matches_jax_on_replayed_draws(canvas, n_objects):
    templates = make_template_bank(16, 28, seed=1)
    kw = dict(canvas_size=canvas, n_timesteps=6, n_objects=n_objects)
    jgen = JOnDeviceSeqMNIST(templates, **kw)
    gen = OnDeviceSeqMNIST(templates, device="cpu", **kw)
    rng = jax.random.PRNGKey(42)
    want = jgen(rng, 12)
    got = gen.render(_jax_render_draws(jgen, rng, 12))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        assert tuple(got[key].shape) == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-5,
                                   err_msg=key)
    assert float(got["imgs"].max()) <= 1.0 + 1e-6 and float(got["imgs"].min()) >= 0.0


def test_call_draws_from_the_generator_and_feeds_the_sampler():
    """``__call__`` is ``render(draw(generator))``: the same seed gives the
    same batch, counts within n_objects; the device sampler takes the
    output's tensors as JAX's sampler takes JAX's arrays (bench.py)."""
    gen = OnDeviceSeqMNIST(make_template_bank(8, 28, seed=0), n_timesteps=4, device="cpu")
    a = gen(torch.Generator().manual_seed(7), 40)
    b = gen.render(gen.draw(torch.Generator().manual_seed(7), 40))
    for key in a:
        assert torch.equal(a[key], b[key]), key
    counts = a["nums"][0].sum(-1)
    assert counts.min() >= 0 and counts.max() <= 2 and len(set(counts.tolist())) == 3
    sampler = DeviceDatasetSampler({"imgs": a["imgs"], "nums": a["nums"]}, "cpu")
    host = DeviceDatasetSampler({k: a[k].numpy() for k in ("imgs", "nums")}, "cpu")
    jsampler = JSampler({k: a[k].numpy() for k in ("imgs", "nums")})
    assert sampler.n == host.n == jsampler.n == 40
    assert torch.equal(sampler.imgs, host.imgs) and torch.equal(sampler.nums, host.nums)
    np.testing.assert_array_equal(sampler.imgs.numpy(), np.asarray(jsampler.imgs))
    np.testing.assert_array_equal(sampler.nums.numpy(), np.asarray(jsampler.nums))
    batch = sampler.sample(torch.Generator().manual_seed(1), 8)
    assert batch["imgs"].shape == (4, 8, 50, 50) and batch["nums"].shape == (4, 8, 3)
