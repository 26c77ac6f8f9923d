from repro_torch.train.trainer import Trainer, TrainSettings  # noqa: F401
