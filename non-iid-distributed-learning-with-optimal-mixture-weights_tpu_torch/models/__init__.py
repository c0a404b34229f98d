from .linear import Model, get_model, linear_model, xavier_uniform

__all__ = ["Model", "get_model", "linear_model", "xavier_uniform"]
