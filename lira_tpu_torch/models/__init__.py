from .checkpoint import load_train_state, save_train_state
from .metrics import probing_metrics
from .probing_mlp import ProbingMLP, params_from_jax, params_to_jax
from .train import (
    TrainState, evaluate, infer, make_train_state, predict_counts, train_epoch,
    train_state_from_jax, train_state_to_jax,
)

__all__ = [
    "ProbingMLP",
    "params_from_jax",
    "params_to_jax",
    "TrainState",
    "make_train_state",
    "train_epoch",
    "evaluate",
    "infer",
    "predict_counts",
    "train_state_from_jax",
    "train_state_to_jax",
    "save_train_state",
    "load_train_state",
    "probing_metrics",
]
