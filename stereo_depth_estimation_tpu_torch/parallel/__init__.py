from .train_step import (
    TrainState,
    create_train_state,
    make_adamw,
    make_device_data_train_step,
    make_eval_step,
    make_lr_schedule,
    make_predict_fn,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_adamw",
    "make_device_data_train_step",
    "make_eval_step",
    "make_lr_schedule",
    "make_predict_fn",
    "make_train_step",
]
