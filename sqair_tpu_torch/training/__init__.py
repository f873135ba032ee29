from .train import (TFRMSProp, TrainState, gradient_summaries, init_train, make_eval_step,
                    make_grad_fn, make_lr_schedule, make_optimizer, make_train_step,
                    named_grad_leaves)
