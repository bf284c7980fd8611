"""Training: CosyVoice speech-LM SFT (the reference's Greek fine-tune
workflow), on the card unless asked for the CPU."""

from .data import DynamicFrameBatcher, shuffle_buffer, sort_buffer
from .sft import (
    SFTBatch,
    TrainState,
    eval_step,
    init_train_state,
    lm_loss,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "DynamicFrameBatcher",
    "SFTBatch",
    "TrainState",
    "eval_step",
    "init_train_state",
    "lm_loss",
    "make_optimizer",
    "make_train_step",
    "shuffle_buffer",
    "sort_buffer",
]
