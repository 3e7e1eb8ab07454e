"""The paper's own experimental configuration (Sec. V): ResNet-20-family
CNN on CIFAR-10-shaped data, n = 10 clients, T = 8 local steps, SGD
lr = 0.05 + weight decay 1e-4, batch 64, PS momentum 0.9.

``reduced()`` shrinks widths/batch so a few hundred rounds run on one CPU
core in the benchmark harness while keeping every protocol parameter
(n, T, lr, momentum, topologies) at the paper's values.
"""

import dataclasses

from repro_torch.models.cnn import CNNConfig


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    cnn: CNNConfig
    n_clients: int = 10
    local_steps: int = 8  # the paper's T
    lr: float = 0.05
    weight_decay: float = 1e-4
    server_momentum: float = 0.9
    batch_size: int = 64
    non_iid_s: int = 3


def full() -> PaperSetup:
    return PaperSetup(cnn=CNNConfig(name="resnet20", widths=(16, 32, 64), blocks_per_stage=3))


def reduced(batch_size: int = 32) -> PaperSetup:
    return PaperSetup(
        cnn=CNNConfig(name="resnet20-thin", widths=(8, 16, 32), blocks_per_stage=1),
        batch_size=batch_size,
    )
