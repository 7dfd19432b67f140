from bert_vits2_tpu_torch.train.step import (
    DataConfig,
    Models,
    TrainConfig,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)

__all__ = ["DataConfig", "Models", "TrainConfig", "TrainState",
           "init_train_state", "make_optimizer", "make_train_step"]
