from repro_torch.optim.adam import adamw
from repro_torch.optim.base import Optimizer, apply_updates, global_norm
from repro_torch.optim.schedule import constant, cosine_decay, inverse_round_decay, warmup_cosine
from repro_torch.optim.sgd import sgd, sgd_momentum

__all__ = ["Optimizer", "apply_updates", "global_norm", "sgd", "sgd_momentum", "adamw",
           "constant", "cosine_decay", "inverse_round_decay", "warmup_cosine"]
