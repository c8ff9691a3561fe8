"""Model substrate of the port: the paper's CNNs (AlexNet, GoogLeNet,
ResNet-50) as ``nn.Module``s with analytic FLOP/byte accounting, and the LM
substrate (dense, MoE, SSM, hybrid RG-LRU, VLM cross-attention and audio
transformers) with prefill and decode caches."""

from . import attention, cnn, layers, moe, rglru, ssm, transformer

__all__ = ["attention", "cnn", "layers", "moe", "rglru", "ssm", "transformer"]
