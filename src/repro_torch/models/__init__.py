from .api import Model, build_model
from .weights import (load_reference_checkpoint, load_reference_train_state,
                      params_from_numpy, train_state_from_numpy)

__all__ = ["Model", "build_model", "load_reference_checkpoint",
           "load_reference_train_state", "params_from_numpy",
           "train_state_from_numpy"]
