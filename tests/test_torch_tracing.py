"""The port's tracing (sqair_tpu_torch/tracing.py) and its hooks in the
chained train step (training/graph.py).

On the CPU: spans nest with their parent and call index, self time is the
duration less the children's; tracing off records no per-call span; the
span ring is bounded; ``summary()``'s medians and p90; the replays read
out of a made-up stamp ring (one that wrapped included) and their gap
share; a summary of one interval continued from the replay before it, and
``records()`` of a range of calls; the clock offset from made-up brackets;
gap labels by the innermost overlapping span; a CPU chain call records
``sqair.chain.rates_fill`` only while tracing is on.  On the card (the
``cuda`` marker; skips without one and imports no JAX: ``python -m pytest
tests/test_torch_tracing.py -m cuda --noconftest``): a replay advances the
ring's launched replays by one and leaves its first stamp at or before its
last, the stamps leave the capture's launch counts as an eager step's, and
the gaps between replays on the aligned clock are not negative.
"""
import numpy as np
import pytest
import torch

from sqair_tpu_torch import tracing
from sqair_tpu_torch.configs import mlp_mnist_model
from sqair_tpu_torch.data import DeviceDatasetSampler, create_seq_dataset, make_template_bank
from sqair_tpu_torch.ops import fused
from sqair_tpu_torch.ops.noise import GeneratorNoise
from sqair_tpu_torch.training import init_train, make_train_step
from sqair_tpu_torch.training.graph import make_chained_train_step

FLAGS = dict(n_units=2, k_particles=2, learning_rate=1e-3, train_itr=8,
             early_disc_logit_scale=0.15, transient_disc_penalty=400.0)
B, T = 4, 2


@pytest.fixture(autouse=True)
def fresh_tracing():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def data():
    d = create_seq_dataset(n_samples=16, n_timesteps=3, canvas_size=(50, 50),
                           obj_size=(28, 28), seed=0, templates=make_template_bank(32, 28, 0))
    d["imgs"] = d["imgs"].astype(np.float32) / 255.0
    return d


def _chain(data, device, steps):
    model = mlp_mnist_model.load(FLAGS, (50, 50), mean_img=data["imgs"].mean((0, 1)),
                                 device=device)
    factory, l2 = mlp_mnist_model.make_optimizer(FLAGS)
    state = init_train(model, factory)
    sampler = DeviceDatasetSampler(data, device)
    g_data = torch.Generator(device=device).manual_seed(0)
    g_noise = torch.Generator(device=device).manual_seed(2)
    return make_chained_train_step(model, state, lambda: sampler.sample(g_data, B), steps, T,
                                   l2, lambda itr: GeneratorNoise(g_noise, device),
                                   [g_data, g_noise])


def _span(name, start, end, parent=None, call=0):
    s = tracing.Span(name, {})
    s.start, s.end, s.parent, s.call = start, end, parent, call
    return s


def test_spans_nest_with_parent_and_call_index():
    tracing.enable()
    tracing.call()
    with tracing.span("a") as a:
        with tracing.span("b") as b:
            pass
    tracing.call()
    with tracing.span("a") as a2:
        pass
    assert (a.parent, b.parent, a2.parent) == (None, a.id, None)
    assert (a.call, b.call, a2.call) == (0, 0, 1)
    assert tracing.mark() == 2
    stats = tracing.summary()["spans"]
    assert stats["a"]["count"] == 2 and stats["b"]["count"] == 1
    assert stats["a"]["self_s"] == pytest.approx(
        stats["a"]["total_s"] - stats["b"]["total_s"], abs=1e-12)
    assert stats["b"]["self_s"] == stats["b"]["total_s"]


def test_self_time_is_duration_less_children():
    spans = [_span("call", 0, 100), _span("fill", 10, 40, parent=None),
             _span("launch", 50, 70)]
    spans[1].parent = spans[2].parent = spans[0].id
    spans.append(_span("inner", 55, 60, parent=spans[2].id))
    stats = tracing.span_stats(spans)
    assert stats["call"]["self_s"] == pytest.approx(50e-9)
    assert stats["launch"]["self_s"] == pytest.approx(15e-9)
    assert stats["fill"]["self_s"] == stats["fill"]["total_s"] == pytest.approx(30e-9)


def test_off_records_nothing_but_advances_the_call_index():
    assert not tracing.summary()["enabled"]
    tracing.call()
    with tracing.span("a") as a:
        pass
    assert a is None and not tracing._spans and tracing.mark() == 1
    with tracing.setup_span("sqair.chain.prepare", leaf=False):
        pass
    assert tracing.last("sqair.chain.prepare").call == 0  # one-off spans always


def test_the_span_ring_is_bounded():
    tracing.enable()
    for _ in range(tracing.SPAN_RING + 10):
        with tracing.span("a"):
            pass
    assert len(tracing._spans) == tracing.SPAN_RING
    assert tracing.summary()["spans"]["a"]["count"] == tracing.SPAN_RING


def test_summary_medians_and_p90():
    spans = [_span("a", 0, ms * 1_000_000) for ms in (5, 1, 3, 2, 4, 10, 6, 7, 8, 9)]
    spans.append(_span("b", 0, 2_000_000))
    spans.append(_span("b", 0, 4_000_000))
    stats = tracing.span_stats(spans)
    assert stats["a"]["median_ms"] == pytest.approx(5.5)
    assert stats["a"]["p90_ms"] == pytest.approx(9.0)  # nearest rank: the 9th of 10
    assert stats["a"]["total_s"] == pytest.approx(0.055)
    assert stats["b"]["median_ms"] == pytest.approx(3.0)
    assert stats["b"]["count"] == 2


def test_replays_and_gaps_from_made_up_stamps():
    # three replays, stamps in order: (first, last) = (0, 10), (13, 23), (25, 35)
    ring = [0, 10, 13, 23, 25, 35, 0, 0]
    replays = tracing.ring_replays(6, ring, [7, 8, 9], 3)
    assert replays == [(7, 0, 10), (8, 13, 23), (9, 25, 35)]
    assert tracing.gap_share(replays) == pytest.approx(100 * 5 / 35)
    assert tracing.gap_share(replays[:1]) is None


def test_a_ring_that_wrapped_keeps_the_newest_replays():
    # a ring of 3 replays (6 stamps) after 5 replays: stamps 4..9 remain,
    # replay k at stamps 2k, 2k + 1 (mod 6); the host kept 4 call indices
    stamps = [100 * k + d for k in range(5) for d in (0, 10)]
    ring = [0] * 6
    for j, v in enumerate(stamps):
        ring[j % 6] = v
    replays = tracing.ring_replays(10, ring, [11, 12, 13, 14], 5)
    assert replays == [(12, 200, 210), (13, 300, 310), (14, 400, 410)]
    assert tracing.gap_share(replays) == pytest.approx(100 * 180 / 210)
    # a replay launched but not yet stamped is left out
    assert tracing.ring_replays(9, ring, [11, 12, 13, 14], 5)[-1] == (13, 300, 310)


def test_an_interval_continues_from_the_replay_before_it():
    # replays of calls 0..2 at (first, last) = (0, 10), (13, 23), (25, 35)
    ring = tracing.StampRing("cpu", lambda buf: None, replays=4)
    ring.buf[:7] = torch.tensor([6, 0, 10, 13, 23, 25, 35])
    for _ in range(3):
        tracing.call()
        ring.replayed()
    tracing.register(ring)
    with tracing.setup_span("sqair.chain.prepare"):
        pass  # a one-off span of call 2
    # one call alone has no gap; continued, its gap from call 1's replay
    # over the stretch from that replay's end
    assert tracing.summary(calls=(2, 3))["replays"]["gap_share_pct"] is None
    out = tracing.summary(calls=(2, 3), continued=True)
    assert out["replays"]["count"] == 1 and out["replays"]["gap_share_pct"] == pytest.approx(
        100 * 2 / 12)
    assert out["replays"]["gap_ms_median"] == pytest.approx(2e-6)
    assert out["gaps"] == [[tracing.NOT_ALIGNED, pytest.approx(2e-6)]]
    assert tracing.gap_share([(2, 25, 35)], (1, 13, 23)) == pytest.approx(100 * 2 / 12)
    # from the first interval on, nothing before it to continue from
    assert tracing.summary(calls=(0, 2), continued=True)["replays"]["gap_share_pct"] == (
        pytest.approx(100 * 3 / 23))
    spans, replays, host = tracing.records((1, 3))
    assert replays == [(1, 13, 23), (2, 25, 35)] and host is None
    assert [s.name for s in spans] == ["sqair.chain.prepare"]
    assert tracing.records((0, 2))[0] == []


def test_the_clock_offset_from_made_up_brackets():
    # the device clock runs 1000 ns ahead; the narrowest bracket wins
    brackets = [(0, 1_050, 400), (1_000, 2_010, 1_020), (5_000, 6_100, 5_400)]
    at, offset, uncertainty = tracing.clock_offset(brackets)
    assert (at, offset, uncertainty) == (1_010, 1_000, 10)
    # two calibrations 1e9 ns apart, the offset grown by 1000 ns: a drift
    # of 1 ppm, taken out along a straight line
    host = tracing.to_host([(0, 1_000, 5), (1_000_000_000, 2_000, 5)])
    assert host(1_000) == pytest.approx(0.0)
    assert host(500_000_000 + 1_500) == pytest.approx(500_000_000, abs=1e-3)
    assert tracing.to_host([(10, 7, 1)])(107) == pytest.approx(100)


def test_gaps_are_labelled_by_the_innermost_span_that_overlaps_most():
    call = _span("outer", 0, 1000)
    fill = _span("sqair.chain.rates_fill", 0, 420, parent=call.id)
    launch = _span("sqair.chain.graph_launch", 430, 600, parent=call.id)
    other = _span("harness", 600, 900)
    spans = [call, fill, launch, other]
    gaps = [(400, 500), (700, 950), (580, 620), (1100, 1200)]
    out = tracing.label_gaps(gaps, spans)
    # longest first.  (700, 950): "outer" is innermost there beside
    # "harness", and overlaps 250 against its 200.  (400, 500): "outer"
    # covers it but has children there; the launch overlaps 70 of it, the
    # fill 20.  (1100, 1200): nothing.  (580, 620): the launch and
    # "harness" overlap 20 each: the shorter wins.
    assert [label for label, _ in out] == ["outer", "sqair.chain.graph_launch",
                                           tracing.NO_SPAN, "sqair.chain.graph_launch"]
    assert [ms for _, ms in out] == pytest.approx([250e-6, 100e-6, 100e-6, 40e-6])  # ns -> ms
    assert tracing.label_gaps(gaps, spans, n=1) == out[:1]


def test_a_cpu_chain_call_records_rates_fill_only_while_tracing_is_on(data):
    chain = _chain(data, "cpu", 1)
    assert chain.stamps is None
    chain()
    assert tracing.summary()["spans"] == {} and tracing.mark() == 1
    tracing.enable()
    chain()
    chain()
    tracing.disable()
    chain()
    out = tracing.summary()
    assert out["spans"]["sqair.chain.rates_fill"]["count"] == 2
    assert "sqair.chain.graph_launch" not in out["spans"] and "replays" not in out
    assert sorted(s.call for s in tracing._spans if s.name == "sqair.chain.rates_fill") == [1, 2]
    assert out["calls"] == 4
    assert tracing.summary(calls=(2, 3))["spans"]["sqair.chain.rates_fill"]["count"] == 1


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_replay_advances_replays_by_one_with_ordered_stamps(data):
    _cuda()
    chain = _chain(data, "cuda", 2)
    chain()
    assert chain.stamps.launched == 1
    assert [s["name"] for s in tracing.summary()["setup"]].count("sqair.chain.prepare") == 1
    assert tracing.last("sqair.chain.capture").parent == tracing.last("sqair.chain.prepare").id
    chain()
    assert chain.stamps.launched == 2
    replays = chain.stamps.read()
    assert [r[0] for r in replays] == [0, 1]
    assert all(first <= last for _, first, last in replays)
    assert replays[0][2] <= replays[1][1]


@pytest.mark.cuda
def test_stamps_leave_the_launch_counts_as_an_eager_steps(data):
    _cuda()
    model = mlp_mnist_model.load(FLAGS, (50, 50), mean_img=data["imgs"].mean((0, 1)),
                                 device="cuda")
    factory, l2 = mlp_mnist_model.make_optimizer(FLAGS)
    step = make_train_step(model, factory, l2)
    sampler = DeviceDatasetSampler(data, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fused.reset_launches()
    b = sampler.sample(gen, B)
    step(b["imgs"][:T], b["nums"][:T], GeneratorNoise(gen, "cuda"))
    torch.cuda.synchronize()
    one_step = dict(fused.launches)
    chain = _chain(data, "cuda", 2)
    chain()
    assert chain.launches == {k: 2 * v for k, v in one_step.items()}


@pytest.mark.cuda
def test_aligned_gaps_between_replays_are_not_negative(data):
    _cuda()
    chain = _chain(data, "cuda", 1)
    chain()
    torch.cuda.synchronize()
    tracing.enable()
    for _ in range(6):
        chain()
    out = tracing.summary(calls=(1, tracing.mark()))
    assert out["replays"]["count"] == 6 and out["clock"]["uncertainty_ms"] < 0.1
    assert 0 <= out["replays"]["gap_share_pct"] < 100
    assert len(out["gaps"]) == 5 and all(ms >= 0 for _, ms in out["gaps"])
    assert all(label != tracing.NO_SPAN for label, _ in out["gaps"])
    # each replay starts on the card after its launch began on the host
    spans, replays, host = tracing.records((1, tracing.mark()))
    launches = {s.call: s for s in spans if s.name == "sqair.chain.graph_launch"}
    slack = 1e6 * out["clock"]["uncertainty_ms"]
    for call, first, _ in replays:
        assert host(first) >= launches[call].start - slack
