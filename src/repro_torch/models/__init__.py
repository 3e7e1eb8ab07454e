"""Models of the port: the paper's GroupNorm ResNet-20 CNN and the model
zoo (the encoder-decoder, the Mamba/attention hybrid with its MoE MLPs,
and the dense, MoE, RWKV6 and VLM decoder-only LMs), behind the
reference's :func:`build` interface."""

from repro_torch.models.cnn import CNNConfig
from repro_torch.models.common import ModelConfig, count_params
from repro_torch.models.registry import ModelBundle, build

__all__ = ["ModelConfig", "CNNConfig", "ModelBundle", "build", "count_params"]
