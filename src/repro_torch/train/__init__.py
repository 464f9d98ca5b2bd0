from .trainer import Trainer, TrainerConfig  # noqa
