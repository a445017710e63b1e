"""Training (the reference's ``train/``): the BNN trainer, the LM step and
``Trainer``, atomic checkpoints and ``rescale``."""
from repro_torch.train.elastic import rescale
from repro_torch.train.train_step import loss_fn, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig, eval_loss

__all__ = ["Trainer", "TrainerConfig", "eval_loss", "loss_fn", "make_train_step", "rescale"]
