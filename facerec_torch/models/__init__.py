"""PyTorch models of the port: the single-stage face detector and the
FaceNet (Inception-ResNet-v1) embedder, with module names that mirror
the JAX package's parameter trees (:mod:`.convert` carries weights
across), and ArcFace IResNet-100 with insightface's module names."""
from facerec_torch.models.detector import DetectorHarness, FaceDetector
from facerec_torch.models.facenet import (FaceNet, FaceNetEmbedder,
                                          PooledEmbedders)
from facerec_torch.models.iresnet import ArcFaceEmbedder, IResNet
