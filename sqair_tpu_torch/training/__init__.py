from .train import (TFRMSProp, TrainState, init_train, make_eval_step, make_lr_schedule,
                    make_optimizer, make_train_step)
