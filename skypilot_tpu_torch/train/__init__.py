"""Training of the port: the single-device trainer of the causal LMs
(``train.trainer``), LoRA adapters (``train.lora``) and the task loops of
BERT and ResNet (``train.tasks``)."""
from skypilot_tpu_torch.train.trainer import (Trainer, TrainConfig,
                                              TrainState, make_eval_step,
                                              make_optimizer,
                                              make_train_step)

__all__ = ['Trainer', 'TrainConfig', 'TrainState', 'make_eval_step',
           'make_optimizer', 'make_train_step']
