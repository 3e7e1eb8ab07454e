"""Models of the port: the paper's GroupNorm ResNet-20 CNN."""
