"""Training, ported from ``repro.training``: synthetic data
(``lm_batches``, ``ClassificationData``), the AdamW optimizer (the
reference's functional update and an in-place one), the LM and
classifier train steps and the classifier's loop; ``checkpoint`` writes
and reads the reference's flat-npz layout."""
from repro_torch.training.data import ClassificationData, lm_batches
from repro_torch.training.optimizer import (AdamW, AdamWState,
                                            cosine_schedule, global_norm)
from repro_torch.training.train_loop import (lm_loss,
                                             make_classifier_train_step,
                                             make_train_step,
                                             train_classifier)

__all__ = [
    "ClassificationData", "lm_batches",
    "AdamW", "AdamWState", "cosine_schedule", "global_norm",
    "lm_loss", "make_classifier_train_step", "make_train_step",
    "train_classifier",
]
