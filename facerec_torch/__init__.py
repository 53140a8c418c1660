"""PyTorch/CUDA port of the facerec pipeline for NVIDIA Hopper GPUs.

A second package beside ``facerec_tpu`` (the JAX reference).  It
imports ``torch``, numpy and the standard library only — never JAX and
never ``facerec_tpu`` — and writes the same file contract byte for
byte.  Module layout and names follow ``facerec_tpu`` so each module
has an obvious counterpart.

Entry point of this slice: the extract stage,
``python -m facerec_torch.pipeline.extract --device cuda FILE``.
"""
