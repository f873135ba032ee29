from .train import (SGD, Adam, Momentum, TFRMSProp, TrainState, gradient_summaries,
                    init_train, is_disc_steps_kernel, make_eval_step, make_grad_fn,
                    make_lr_schedule, make_optimizer, make_train_step, named_grad_leaves,
                    scale_coverage_row_updates)
