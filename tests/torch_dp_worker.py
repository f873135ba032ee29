"""One process of the port's multi-process CPU tests (tests/test_torch_parallel.py).

Run by the tests, never by pytest:

    python tests/torch_dp_worker.py SPEC RANK WORLD PORT OUT

It joins a gloo process group of WORLD processes at 127.0.0.1:PORT, builds
``tiny_model`` (tests/test_parallel_fused.py's widths) with the weights in
SPEC (a ``torch.save``d dict), and runs on the data mesh, with the noise
SPEC gives this rank: an eval step (``make_parallel_eval_step``) on the
weights, then ``steps`` train steps (``make_parallel_train_step``).  It
writes to OUT.<RANK> the eval metrics, each train step's metrics and
parameter digest, the parameters after the steps and the last step's
mean gradients.  It imports neither JAX nor the JAX package.
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import param_digest  # noqa: E402
from sqair_tpu_torch.models import AIRDecoder, Model, SequentialAIR, SQAIRTimestep  # noqa: E402

B, T, S, HW, NWHAT, NH = 8, 2, 2, 16, 4, 16


def tiny_model(k=2, aspect_penalty=0.0):
    ts = SQAIRTimestep(n_steps=S, img_size=(HW, HW), glimpse_size=(6, 6), n_what=NWHAT,
                       n_hidden=NH, steps_pred_hidden=[8])
    dec = AIRDecoder(img_size=(HW, HW), glimpse_size=(6, 6), n_what=NWHAT,
                     glimpse_n_hiddens=[NH], mean_img=np.zeros((HW, HW), np.float32))
    return Model(SequentialAIR(ts, dec), k_particles=k, aspect_penalty=aspect_penalty)


def main(spec_path, rank, world, port, out_path):
    torch.set_num_threads(1)
    from sqair_tpu_torch.ops.noise import ReplayNoise
    from sqair_tpu_torch.parallel import (initialize, make_mesh, make_parallel_eval_step,
                                          make_parallel_train_step)
    from sqair_tpu_torch.parallel.mesh import make_multislice_mesh
    from sqair_tpu_torch.training import make_optimizer

    spec = torch.load(spec_path, weights_only=False)
    initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
    mesh = make_multislice_mesh(spec["slices"]) if spec.get("slices") else make_mesh()
    model = tiny_model(aspect_penalty=spec.get("aspect_penalty", 0.0))
    model.sequence.load_state_dict(spec["weights"])
    obs, nums = spec["obs"], spec["nums"]
    noise = spec["noise"]  # [eval, step 0, step 1, ...] of {rank: table}
    out = {"eval": {k: v.clone() for k, v in make_parallel_eval_step(model, mesh)(
        obs, nums, ReplayNoise(noise[0][rank], "cpu")).items()}}
    opt, lr = spec.get("opt", ("rmsprop", 1e-3))
    step = make_parallel_train_step(model, make_optimizer(opt, lr), mesh)
    out["train"], out["digests"] = [], []
    for i in range(spec.get("steps", 1)):
        out["train"].append(step(obs, nums, ReplayNoise(noise[1 + i][rank], "cpu")))
        out["digests"].append(param_digest(model.sequence))
    out["params"] = {k: v.clone() for k, v in model.sequence.state_dict().items()}
    out["grads"] = {n: p.grad.clone() for n, p in model.sequence.named_parameters()
                    if p.grad is not None}
    torch.save(out, f"{out_path}.{rank}")
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
