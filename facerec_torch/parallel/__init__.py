"""Multi-device extract and data-parallel training, one process per
device (port of ``facerec_tpu/parallel``).

The reference scales by SLURM array jobs over a shared filesystem
(SURVEY.md §2.4).  Here the same temporal decomposition runs one
process per device: :mod:`~facerec_torch.parallel.extract_mesh` gives
each device a contiguous span of the film (no collectives), and
:mod:`~facerec_torch.parallel.extract_sharded` splits one block over the
ranks with a 2-frame halo.  The collectives, all built on
``all_reduce``, and the process launcher are in
:mod:`~facerec_torch.parallel.mesh`.
"""
from facerec_torch.parallel.mesh import FRAME_AXIS, mesh_devices, run_ranks
