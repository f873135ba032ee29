from .train import make_eval_step
