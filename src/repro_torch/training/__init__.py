"""Training (port of ``repro.training``): AdamW, the step builders, the
host loop and checkpoints."""

from repro_torch.training.optimizer import OptimizerConfig, apply_updates, init_state
from repro_torch.training.train_loop import (
    TrainResult,
    make_diffusion_train_step,
    make_lm_train_step,
    train,
)
