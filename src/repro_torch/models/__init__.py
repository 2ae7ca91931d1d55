"""DistilBERT, ResNet-18, the LM of every configuration (attention, MLA,
SSD and RG-LRU layers, dense or MoE, mixed stacks, the prefix-LM and the
encoder-decoder) and their building blocks, ported from
``repro.models``; ``convert`` carries the reference's weights
across."""
from repro_torch.models.convert import (distilbert_from_numpy,
                                        lm_from_numpy, resnet_from_numpy)
from repro_torch.models.distilbert import DistilBERT
from repro_torch.models.resnet import ResNet18
from repro_torch.models.transformer import LM

__all__ = ["DistilBERT", "LM", "ResNet18", "distilbert_from_numpy",
           "lm_from_numpy", "resnet_from_numpy"]
