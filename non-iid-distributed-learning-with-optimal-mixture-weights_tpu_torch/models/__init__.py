from .conv import conv_model
from .linear import Model, get_model, linear_model, mlp_model, xavier_uniform

__all__ = ["Model", "conv_model", "get_model", "linear_model", "mlp_model",
           "xavier_uniform"]
