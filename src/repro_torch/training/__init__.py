"""Synthetic data, the AdamW optimizer and the classifier's training
loop, ported from ``repro.training`` (the LM half waits for its
slice)."""
from repro_torch.training.data import ClassificationData
from repro_torch.training.optimizer import (AdamW, AdamWState,
                                            cosine_schedule, global_norm)
from repro_torch.training.train_loop import (make_classifier_train_step,
                                             train_classifier)

__all__ = [
    "ClassificationData",
    "AdamW", "AdamWState", "cosine_schedule", "global_norm",
    "make_classifier_train_step", "train_classifier",
]
