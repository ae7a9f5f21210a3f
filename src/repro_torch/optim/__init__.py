"""Optimizer of the port (counterpart of ``repro/optim``): AdamW, the
learning-rate schedules and the error-feedback int8 gradient
compression."""
from .adamw import AdamWConfig, AdamWState, apply_updates, global_norm, \
    init_state
from .compression import compress_grads, init_error
from .schedules import constant, warmup_cosine

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "global_norm",
           "init_state", "compress_grads", "init_error", "constant",
           "warmup_cosine"]
