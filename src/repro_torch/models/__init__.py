"""Models of the port: the paper's GroupNorm ResNet-20 CNN and, of the
model zoo, the encoder-decoder (seamless-m4t) and the Mamba/attention
hybrid (jamba, dense MLPs), behind the reference's :func:`build`
interface."""

from repro_torch.models.cnn import CNNConfig
from repro_torch.models.common import ModelConfig, count_params
from repro_torch.models.registry import ModelBundle, build

__all__ = ["ModelConfig", "CNNConfig", "ModelBundle", "build", "count_params"]
