"""Training entry point of the port (sqair_tpu/scripts/experiment.py): the
same flags, run dirs, curriculum and cadences (heartbeat, eval, checkpoint).

Run on the card (``--device cpu`` runs on the CPU):

    python -m sqair_tpu_torch.scripts.experiment \\
        --data_config sqair_tpu/configs/synth_seq_mnist_data.py \\
        --model_config sqair_tpu/configs/mlp_mnist_model.py \\
        --results_dir results --run_name multi_mnist \\
        --seq_len 3 --stage_itr 100000 --on_device_data --steps_per_call 10

The config paths are the JAX package's (as every flags.json holds them);
they name the port's configs of the same name
(``experiment/experiment_tools.py``).  On the card every call of the train
step replays a captured CUDA graph of ``--steps_per_call`` train steps
(``training/graph.py``): with ``--on_device_data`` the training set lives on
the device and each step gathers its batch there; without it each step's
host batch is copied into the graph's input buffers.  ``SQAIR_FUSE_GLIMPSE=1``
and ``SQAIR_FUSE_CELLS=1`` switch the fused kernels on, as in the JAX
package.

The batch indices and the model's noise come from two ``torch.Generator``s
seeded with ``DATA_SEED`` and ``NOISE_SEED``; their states are saved in each
checkpoint, so a resumed run draws what an uninterrupted one would (the
host minibatcher starts again from its seed, as the JAX package's does).
Each eval batch takes the noise of a generator seeded with 1, as the JAX
package passes PRNGKey(1) (``scripts/eval.py`` ``default_noise``).

At the start, every ``--fig_itr`` steps and at the end the progress figures
(``eval_tools.ProgressFig``: still_fig_<itr>.png, seq_fig_<itr>.png) are
drawn from a valid batch, with the noise of a generator seeded with 2 (the
JAX package's PRNGKey(2)), where matplotlib is installed; a figure that
fails falls back to the raw render tensors as tensorboard images.  The
figures' batches come from a valid-set iterator of their own, so a figure
moves no eval's batches (in the JAX package each figure takes the eval
iterator's next batch).

``--coverage_lr_mult`` (with ``--disc_coverage_signal``) multiplies the
updates of the discovery steps predictor's 16 coverage input rows
(``training.scale_coverage_row_updates``).

Several processes (``--coordinator_address host:port --num_processes W
--process_id r``, one process a card; NCCL on the card, gloo with
``--device cpu``) train one model on the data mesh (``parallel/``): every
process draws the same global batch and trains on its rows of it with
noise of its own (its generator seeded from ``NOISE_SEED`` and its rank),
the gradients averaged over the processes.  Process 0 makes the run dir
(and writes flags.json and every checkpoint, with a barrier after each);
the others join it and write their records to ``proc<r>/``.  Each
checkpoint holds every process's noise generator, so a resumed run draws
what an uninterrupted one would.  Evals run through the parallel eval
step; the figures are process 0's.  A SIGTERM to any process is a vote to
stop, gathered every min(report_loss_every, 250) steps: all processes stop
at the same step and save.  A multi-process step runs eager, also on the
card (NCCL's all-reduce is not captured in the step's graph; gloo's cannot
be), and ``--steps_per_call`` > 1 raises.  With ``--num_processes 1`` the CLI
takes the single-process path, a coordinator address or not.  A resume
without ``--device`` sets up the process group for the device in the run's
flags.json (gloo for a CPU run), read before the flags are restored.
"""
from __future__ import annotations

import os
import signal
import sys
import time
from os import path as osp
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..configs.mlp_mnist_model import TRAIN_DEFAULTS, make_optimizer
from ..data.loader import Minibatcher, curriculum_seq_len, truncate_batch
from ..data.moving_mnist import DeviceDatasetSampler
from ..device import resolve_device
from ..eval_tools import MetricWriter, ProgressFig, make_logger
from ..experiment import flags
from ..experiment.experiment_tools import (init_checkpoint, load, parse_flags, print_flags,
                                           print_num_params, run_device)
from ..ops.noise import GeneratorNoise, NoiseSource
from ..parallel import distributed
from ..parallel.mesh import make_mesh, make_parallel_eval_step, make_parallel_train_step
from ..training import (init_train, make_eval_step, make_grad_fn, named_grad_leaves,
                        scale_coverage_row_updates)
from ..training.checkpoint import rank_noise_key, restore_train_state, save_checkpoint
from ..training.graph import TrainSnapshot, make_chained_train_step
from .eval import NOISE_SEED as EVAL_NOISE_SEED
from .eval import default_noise

DATA_SEED, NOISE_SEED = 0, 2
RENDER_SEED = 2  # the JAX package renders its figures with PRNGKey(2)
PROFILED_CALLS = 3

flags.define_all((
    (str, "data_config", "sqair_tpu/configs/synth_seq_mnist_data.py",
     "Path to a data config file."),
    (str, "model_config", "sqair_tpu/configs/mlp_mnist_model.py",
     "Path to a model config file."),
    (str, "results_dir", "results", "Top results directory."),
    (str, "run_name", "test_run", "Name of this job."),
    (int, "batch_size", 32, ""),
    (int, "log_itr", int(1e4), "Iters between full evals."),
    (int, "report_loss_every", int(1e3), "Iters between heartbeats."),
    (int, "save_itr", int(1e5), "Iters between checkpoints."),
    (int, "fig_itr", int(1e4), "Iters between figures."),
    (int, "train_itr", TRAIN_DEFAULTS["train_itr"], "Max training iterations."),
    (bool, "resume", False, "Resume the previous run."),
    (bool, "log_at_start", False, "Evaluate before training."),
    (bool, "eval_on_train", True, "Also evaluate on the train set."),
    (float, "eval_size_fraction", 1.0, "Fraction of data used in evals."),
    (str, "opt", TRAIN_DEFAULTS["opt"],
     "rmsprop | adam | sgd | momentum (the port has rmsprop)"),
    (float, "learning_rate", TRAIN_DEFAULTS["learning_rate"], "Initial learning rate."),
    (float, "l2", TRAIN_DEFAULTS["l2"], "L2 regularisation weight."),
    (str, "schedule", TRAIN_DEFAULTS["schedule"], "Piecewise-constant lr schedule."),
    (int, "profile_itr", 0,
     "If > 0, write a torch.profiler trace of a few train calls at this iteration to "
     "<logdir>/profile (the calls are undone: profiling moves no training)."),
    (bool, "test_run", False, "Tiny smoke-test preset."),
    (str, "gpu", "0", "Unused; kept for CLI parity (--device picks the device)."),
    (bool, "debug", False, "Gradient summaries in the heartbeat's records."),
    (bool, "data_parallel", True,
     "Shard the batch over the processes of a multi-process run (required there)."),
    (str, "coordinator_address", "",
     "host:port of process 0 for multi-process training (torch.distributed). Empty = "
     "single process."),
    (int, "num_processes", 1, "Total processes (multi-process)."),
    (int, "process_id", 0, "This process's id (multi-process)."),
    (bool, "grad_histograms", False,
     "Write per-variable gradient histograms to tensorboard at log_itr cadence."),
    (bool, "on_device_data", False,
     "Keep the training set in device memory and gather each step's batch there."),
    (int, "steps_per_call", 1,
     "With --on_device_data: chain this many train steps in one call (on the card one "
     "captured CUDA graph; the same per-step math and random streams). All cadences "
     "(report/log/save/fig/stage_itr/train_itr) must be divisible by it."),
    (str, "device", "cuda", "cuda, or cpu to train on the CPU."),
))

TEST_RUN = dict(run_name="mnist_test", data_config="sqair_tpu/configs/synth_seq_mnist_data.py",
                model_config="sqair_tpu/configs/mlp_mnist_model.py", seq_len=2,
                eval_on_train=False, report_loss_every=10, log_itr=100, fig_itr=100,
                save_itr=200, train_itr=200, n_units=4, synth_train_samples=64,
                synth_valid_samples=32, synth_timesteps=3, batch_size=8, k_particles=2)


def main(argv: Optional[Sequence[str]] = None,
         train_noise: Optional[Callable[[int], NoiseSource]] = None,
         eval_noise: Optional[Callable[[], NoiseSource]] = None):
    """Trains; returns (run dir, model, train state).

    :param train_noise: step index -> that train step's noise, in place of
        the noise generator's (eager steps only: the CPU); e.g. another
        implementation's noise, replayed
    :param eval_noise: () -> an eval batch's noise
    """
    if argv is not None:
        sys.argv = [sys.argv[0]] + list(argv)

    parse_flags()
    F = flags.FLAGS
    if F.test_run:
        for name, value in TEST_RUN.items():
            setattr(F, name, value)
    device = F.device
    if not F.resume:
        resolve_device(device)  # before a run dir is made (resuming, flags.json has it)
    elif "device" not in F._cli_set:
        device = run_device(osp.join(F.results_dir, F.run_name), device)
    # the process group, before any tensor is built; its backend follows the
    # device (a resume's: the run's own, unless --device names one)
    joined = distributed.initialize(F.coordinator_address, F.num_processes, F.process_id,
                                    device=device)
    if joined:
        print(f"multi-process: process {distributed.process_index()}/"
              f"{distributed.process_count()}")
    try:
        return _train(F, train_noise, eval_noise)
    finally:
        if joined:
            distributed.shutdown()


def _train(F, train_noise, eval_noise):
    rank, world = distributed.process_index(), distributed.process_count()
    multi = world > 1

    run_root = osp.join(F.results_dir, F.run_name)
    if rank == 0:
        logdir, _, resume_checkpoint = init_checkpoint(run_root, F.data_config,
                                                       F.model_config, F.resume)
    # process 0 makes (or finds) the run dir; the others join it
    distributed.barrier()
    if rank != 0:
        logdir, _, resume_checkpoint = init_checkpoint(run_root, F.data_config,
                                                       F.model_config, F.resume, attach=True)
    device = resolve_device(F.device)
    if train_noise is not None and device.type == "cuda":
        raise ValueError("a train_noise hook runs eager steps: pass --device cpu")
    if multi and (not F.data_parallel or F.batch_size % world):
        # each process computing the whole step would just repeat it
        raise ValueError(
            f"a multi-process run needs the data mesh: batch_size={F.batch_size} must be "
            f"divisible by the {world} processes and --data_parallel must be on "
            f"(got {F.data_parallel})")
    if multi and int(F.steps_per_call) > 1:
        raise ValueError(
            "--steps_per_call > 1 requires --on_device_data and is incompatible with the "
            f"data-parallel mesh path (on_device_data={F.on_device_data}, "
            "data_parallel active=True)")
    if F.coverage_lr_mult != 1.0 and not F.disc_coverage_signal:
        raise ValueError("--coverage_lr_mult requires --disc_coverage_signal")

    # ------------------------------------------------------------- data
    data_dict = load(F.data_config, F.batch_size)
    train_imgs = data_dict["train_data"]["imgs"]
    mean_img = train_imgs.mean(tuple(range(train_imgs.ndim - 2)))

    # ------------------------------------------------------------ model
    example_batch = next(data_dict["train_iter"])
    model = load(F.model_config, F.as_dict(), example_batch["imgs"].shape[2:],
                 mean_img=mean_img, device=device)
    factory, l2 = make_optimizer(F.as_dict())
    if F.coverage_lr_mult != 1.0:
        factory = scale_coverage_row_updates(factory, F.coverage_lr_mult,
                                             model.sequence.named_parameters())
        print(f"coverage rows lr mult: {F.coverage_lr_mult} (effective lr "
              f"{F.learning_rate * F.coverage_lr_mult:g} on the 16 coverage rows)")
    state = init_train(model, factory)
    print_flags()
    print_num_params(model.sequence)
    # every process draws the same batches and noise of its own
    noise_key = rank_noise_key(rank)
    generators = {"data": torch.Generator(device=device).manual_seed(DATA_SEED),
                  noise_key: torch.Generator(device=device).manual_seed(
                      distributed.rank_seed(NOISE_SEED, rank))}
    if resume_checkpoint is not None:
        print(f"Restoring checkpoint from '{resume_checkpoint}'")
        restore_train_state(resume_checkpoint, model.sequence, state, generators)
    mesh = None
    if multi:
        mesh = make_mesh()
        distributed.replicate_to_mesh(model.sequence, mesh, state.optimizer)
        print(f"data-parallel over {world} processes")

    max_T = data_dict["max_timesteps"]

    def stage_len(itr):
        return curriculum_seq_len(itr, data_dict["seq_len"], data_dict["stage_itr"], max_T)

    # ------------------------------------------------------- train step
    steps_per_call = 1
    if F.on_device_data:
        sampler = DeviceDatasetSampler({"imgs": train_imgs,
                                        "nums": data_dict["train_data"]["nums"]}, device)
        steps_per_call = max(1, int(F.steps_per_call))
        if steps_per_call > 1:
            # chained calls advance train_itr in blocks: every cadence and
            # every stage boundary must land on a block boundary
            for fname in ("report_loss_every", "log_itr", "save_itr", "fig_itr", "train_itr"):
                v = getattr(F, fname)
                if v % steps_per_call:
                    raise ValueError(f"--{fname}={v} must be divisible by "
                                     f"--steps_per_call={steps_per_call}")
            if data_dict["stage_itr"] % steps_per_call:
                raise ValueError(f"stage_itr={data_dict['stage_itr']} must be divisible "
                                 f"by --steps_per_call={steps_per_call}")
        print("on-device data: training set resident in device memory, sampling inside "
              f"the train step ({steps_per_call} step(s) per call)")

        def source():
            return sampler.sample(generators["data"], F.batch_size)
    else:
        if int(F.steps_per_call) > 1:
            raise ValueError(
                "--steps_per_call > 1 requires --on_device_data and is incompatible with "
                f"the data-parallel mesh path (on_device_data={F.on_device_data}, "
                "data_parallel active=False)")
        buffers = {k: torch.empty(example_batch[k].shape, dtype=torch.float32, device=device)
                   for k in ("imgs", "nums")}

        def source():
            return buffers

    noise_gen = generators[noise_key]
    noise = train_noise or (lambda itr: GeneratorNoise(noise_gen, device))
    chain = None
    if multi:
        parallel_step = make_parallel_train_step(model, state, mesh, l2)

        def eager_for(seq_len):
            # one eager step a call, on this process's rows of the batch
            def step():
                b = source()
                return parallel_step(b["imgs"][:seq_len], b["nums"][:seq_len],
                                     noise(state.step))
            return step

    def chain_for(seq_len):
        # one captured chain a curriculum stage: the last stage's graph and
        # its memory go first
        nonlocal chain
        if chain is None or chain.seq_len != seq_len:
            if chain is not None:
                chain.release()
            chain = make_chained_train_step(model, state, source, steps_per_call, seq_len, l2,
                                            noise, list(generators.values()),
                                            grad_summaries=F.debug)
        return chain

    # ---------------------------------------------------------- logging
    eval_step = make_parallel_eval_step(model, mesh) if multi else make_eval_step(model)
    eval_noise = eval_noise or default_noise(device,
                                             distributed.rank_seed(EVAL_NOISE_SEED, rank))
    # the other processes keep records of their own, out of the run dir's
    writer = (MetricWriter(osp.join(logdir, f"proc{rank}"), use_tb=False) if rank
              else MetricWriter(logdir))
    factor = F.eval_size_fraction
    ax = data_dict["axes"]["imgs"]
    train_batches = max(1, int(data_dict["train_data"]["imgs"].shape[ax] * factor
                               / F.batch_size))
    valid_batches = max(1, int(data_dict["valid_data"]["imgs"].shape[ax] * factor
                               / F.batch_size))
    log = make_logger(lambda obs, nums: eval_step(obs, nums, eval_noise()), writer,
                      data_dict["train_iter"], train_batches, data_dict["valid_iter"],
                      valid_batches, F.eval_on_train, seq_len_fn=stage_len)

    def render_fn(obs, nums):
        with torch.inference_mode():
            gen = torch.Generator(device=device).manual_seed(RENDER_SEED)
            _, aux = model.loss_and_metrics(
                torch.as_tensor(obs, device=device), GeneratorNoise(gen, device),
                torch.as_tensor(nums, device=device), render=True)
        return aux["render"]

    progress_fig = ProgressFig(render_fn, logdir, img_size=mean_img.shape,
                               glimpse_size=[int(F.glimpse_size)] * 2, seq_n_samples=4)
    fig_iter = Minibatcher(data_dict["valid_data"], F.batch_size, data_dict["axes"])

    def try_plot(itr):
        if rank:
            return  # process 0 draws the figures
        batch = truncate_batch(next(fig_iter), stage_len(itr))
        try:
            progress_fig.plot_all(itr, batch)
        except Exception as e:  # noqa: BLE001 - a figure must never stop training
            print(f"figure plotting failed: {e}")
            # the raw render tensors as tensorboard images instead
            render = render_fn(batch["imgs"], batch["nums"])
            for name in ("obs", "resampled_canvas"):
                frames = render[name][:, 0].cpu().numpy()
                writer.write_image(itr, f"render/{name}", np.concatenate(list(frames), -1))

    grad_fn = None

    def log_grad_histograms(itr):
        nonlocal grad_fn
        grad_fn = grad_fn or make_grad_fn(model, l2)
        b = truncate_batch(next(data_dict["train_iter"]), stage_len(itr))
        # a generator of its own: the histograms draw nothing from training's
        gen = torch.Generator(device=device).manual_seed(itr)
        grads = grad_fn(b["imgs"], b["nums"], GeneratorNoise(gen, device))
        for name, leaf in named_grad_leaves(grads):
            writer.write_histogram(itr, f"grads/{name}", leaf)

    def save(itr):
        rng = dict(generators)
        if multi:
            import torch.distributed as dist

            # every process's noise generator, into process 0's checkpoint
            states = [None] * world
            dist.all_gather_object(states, noise_gen.get_state())
            rng.update({rank_noise_key(r): st for r, st in enumerate(states)})
        if rank == 0:
            save_checkpoint(logdir, itr, model.sequence, state.optimizer, rng)
        distributed.barrier()

    def profile(step):
        trace_dir = osp.join(logdir, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        snapshot = TrainSnapshot(model, state, generators.values())
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(PROFILED_CALLS):
                step()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        snapshot.restore()
        prof.export_chrome_trace(osp.join(trace_dir, "trace.json"))
        print(f"profiler trace written to {trace_dir}")

    # ------------------------------------------------------------- loop
    train_itr = state.step
    if steps_per_call > 1 and train_itr % steps_per_call:
        raise ValueError(
            f"resumed step {train_itr} is not aligned to --steps_per_call={steps_per_call}; "
            f"resume with --steps_per_call 1 (or a divisor of {train_itr})")
    print(f"Starting training at iter = {train_itr}")
    if F.log_at_start or train_itr == 0:
        log(train_itr)
        try_plot(train_itr)

    report_every = F.report_loss_every
    last_saved_itr = -1

    # SIGTERM/SIGINT ask for a graceful stop: the loop breaks at the next
    # call boundary and the final save below checkpoints the step reached.
    # In a multi-process run a process that broke out alone would leave its
    # peers waiting in a collective: the signal is a vote, gathered every
    # vote_every steps (a preemption's grace window is short), and every
    # process stops at the same step
    vote_every = min(report_every, 250)
    stop_signal = {"num": None}
    prev_handlers = {}

    def _graceful_stop(signum, frame):
        stop_signal["num"] = signum

    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[s] = signal.signal(s, _graceful_stop)
    except ValueError:  # not the main thread (in-process callers)
        prev_handlers = {}

    try:
        t0 = time.time()
        frames_done = 0
        while train_itr < F.train_itr:
            if stop_signal["num"] is not None and not multi:
                print(f"signal {stop_signal['num']}: stopping at iter {train_itr}, "
                      "saving checkpoint")
                break
            sl = stage_len(train_itr)
            prev_itr = train_itr
            step = eager_for(sl) if multi else chain_for(sl)
            if not F.on_device_data:
                batch = next(data_dict["train_iter"])
                for k, buf in buffers.items():
                    buf.copy_(torch.from_numpy(batch[k]))
            metrics = step()
            train_itr = state.step
            frames_done += sl * F.batch_size * steps_per_call

            if train_itr % report_every == 0:
                # the calls above only queue the device's work: reading a
                # metric waits for it, before the clock is read
                target_val = float(metrics["target"])
                dt = time.time() - t0
                heartbeat = {
                    "target": target_val,
                    "iwae": float(metrics["normalised_iwae"]),
                    "num_steps": float(metrics["num_steps"]),
                    "num_step_acc": float(metrics.get("num_step_accuracy", np.nan)),
                    "seq_len": sl,
                    "frames_per_sec": frames_done / max(dt, 1e-9),
                }
                print(f"{train_itr}: " + ", ".join(f"{k}={v:.5g}" for k, v in heartbeat.items()))
                writer.write(train_itr, heartbeat)
                if F.debug:
                    writer.write(train_itr, {k: v for k, v in metrics.items()
                                             if k.startswith("grads/")})
                t0, frames_done = time.time(), 0

            if (multi and train_itr % vote_every == 0
                    and mesh.any(stop_signal["num"] is not None)):
                print(f"coordinated stop (a process was signalled): stopping at iter "
                      f"{train_itr}, saving checkpoint")
                break

            if train_itr % F.log_itr == 0:
                log(train_itr)
                if F.grad_histograms:
                    log_grad_histograms(train_itr)
            if train_itr % F.save_itr == 0:
                save(train_itr)
                last_saved_itr = train_itr
            if train_itr % F.fig_itr == 0:
                try_plot(train_itr)
            if (train_itr % F.log_itr == 0 or train_itr % F.save_itr == 0
                    or train_itr % F.fig_itr == 0):
                # evals, saves and figures ran inside the next heartbeat's
                # window: frames_per_sec measures training only
                t0, frames_done = time.time(), 0
            # train_itr advances in steps_per_call blocks: fire on the
            # first boundary at or past profile_itr
            if F.profile_itr and train_itr >= F.profile_itr > prev_itr:
                profile(step)

        if last_saved_itr != train_itr:
            save(train_itr)
        try_plot(train_itr)
        writer.close()
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
    return logdir, model, state


if __name__ == "__main__":
    main()
