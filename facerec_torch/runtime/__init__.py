"""Host runtime of the port: device choice, checkpoints, metrics and
the ctypes bindings of the repo's native helpers."""
from facerec_torch.runtime.device import resolve_device
