"""The embedder families.

An embedder family is a file ``portbench/embedders/<family>.py`` that
``portbench/run.py`` loads by path for a configuration whose
``embedder_family`` names it (a configuration without the key runs
``facenet``, the family of every configuration written before the key
was).  It holds all that the harness knows of the embedders:

- ``states(config, seed, device)``: {name: (dim, state dict)}, the seeded
  weights that the program and the reference both take;
- ``program_bank(states, device, probe)``: the program's bank for
  ``run_extract``, made by :func:`portbench.probe.make_bank`;
- ``warm(bank, stack, block, height, width)``: the bank's first full
  batch, before the timed fetch groups;
- ``reference(states, device)``: the plain reference, a callable of
  frames (uint8, on the device) and saved faces (``frame``, an index into
  the frames; the rounded ``box``; float ``landmarks`` (5, 2)) that
  returns {name: (n, dim) float64};
- ``flops_per_crop(states)``: the model FLOPs of one real crop through
  every network.

The reference half imports nothing of the program; the program half
imports it inside its functions.  A new embedder architecture comes in
as such a file, its reference under ``portbench/reference/``, and its
configuration, limits and cells: no file of the harness changes.
"""
