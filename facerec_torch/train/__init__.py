"""Training: anchor target assignment, losses, train steps, BN
recalibration (port of ``facerec_tpu/train``).  Training runs on one
device; the JAX package's data-parallel mesh waits for multi-GPU."""
from facerec_torch.train.detector_train import (DetectorTrainer, anchor_targets,
                                                detector_loss)
