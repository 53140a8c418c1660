"""Tensor operations of the port: boxes, scene statistics, Kalman
filtering, assignment, NMS, crops, and the hand-written equalize
kernels (:mod:`facerec_torch.ops.equalize`)."""
