from realpdebench_tpu_torch.train.train_step import (
    Optimizer,
    build_optimizer,
    build_schedule,
    make_train_step,
)
