"""Training of the port: the single-device trainer (``train.trainer``) and
LoRA adapters (``train.lora``)."""
from skypilot_tpu_torch.train.trainer import (Trainer, TrainConfig,
                                              TrainState, make_eval_step,
                                              make_optimizer,
                                              make_train_step)

__all__ = ['Trainer', 'TrainConfig', 'TrainState', 'make_eval_step',
           'make_optimizer', 'make_train_step']
