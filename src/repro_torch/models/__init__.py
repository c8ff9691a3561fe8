"""Model substrate of the port: the paper's CNNs (AlexNet, GoogLeNet,
ResNet-50) as ``nn.Module``s with analytic FLOP/byte accounting."""

from . import cnn

__all__ = ["cnn"]
