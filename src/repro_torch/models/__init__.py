"""Model configuration and parameter specs.

Only what the storage-window slice needs: ``ModelConfig`` and the dense
family's ``param_specs``, which give the optimizer a real parameter tree.
The model code itself is a later slice of this package.
"""

from .config import ModelConfig
from .lm import param_specs
from .spec import ParamSpec

__all__ = ["ModelConfig", "ParamSpec", "param_specs"]
