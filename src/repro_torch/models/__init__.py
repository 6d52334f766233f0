from .api import Model, build_model
from .weights import load_reference_checkpoint, params_from_numpy

__all__ = ["Model", "build_model", "load_reference_checkpoint",
           "params_from_numpy"]
