from repro_torch.optim.base import Optimizer, global_norm
from repro_torch.optim.sgd import sgd, sgd_momentum

__all__ = ["Optimizer", "global_norm", "sgd", "sgd_momentum"]
