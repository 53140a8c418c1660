"""Training: anchor target assignment, losses, train steps, BN
recalibration (port of ``facerec_tpu/train``).  Both trainers run on
one device or data parallel over a process group (the JAX package's
``mesh``)."""
from facerec_torch.train.detector_train import (DetectorTrainer, anchor_targets,
                                                detector_loss)
