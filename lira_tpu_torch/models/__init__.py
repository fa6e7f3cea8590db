from .probing_mlp import ProbingMLP, params_from_jax, params_to_jax

__all__ = ["ProbingMLP", "params_from_jax", "params_to_jax"]
