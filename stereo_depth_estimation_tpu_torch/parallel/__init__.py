from .train_step import (
    CompileOptions,
    TrainState,
    compile_model,
    compile_options_from,
    create_train_state,
    make_adamw,
    make_device_data_train_loop,
    make_device_data_train_step,
    make_eval_step,
    make_lr_schedule,
    make_predict_fn,
    make_train_step,
)

__all__ = [
    "CompileOptions",
    "TrainState",
    "compile_model",
    "compile_options_from",
    "create_train_state",
    "make_adamw",
    "make_device_data_train_loop",
    "make_device_data_train_step",
    "make_eval_step",
    "make_lr_schedule",
    "make_predict_fn",
    "make_train_step",
]
