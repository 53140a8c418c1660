"""Resolve on-disk FaceNet weights into the port's embedders.

Port of ``facerec_tpu/models/load.py`` (its FaceNet half).  A weights
directory holds one checkpoint per name, the first match winning:

    <dir>/<name>.pt         facenet-pytorch InceptionResnetV1 state dict
    <dir>/<name>.h5         keras-facenet h5 model file (needs h5py)
    <dir>/<name>.npz        the JAX package's single-file Flax checkpoint
                            (``facerec_tpu/models/weights.py:save_params_npz``)
    <dir>/<name>/model.h5   keras-facenet extracted-archive layout

The JAX package's fourth format, an orbax directory, cannot be read
without JAX: such a directory raises an error that names the ``.npz``
export instead.  The detector loads from a ``.npz`` file
(:meth:`facerec_torch.models.detector.DetectorHarness.from_npz`).

Unlike the JAX package, a directory without ``EMB_NAME`` raises: the
cluster and classify stages read only that embedding, so a random one
would make every later file meaningless.  Other missing names get a
loud random init (:func:`warn_random_init`).
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import torch

from facerec_torch.config import EMB_NAME, FACENET_DIMS, FACENET_MODELS
from facerec_torch.models import convert
from facerec_torch.models import weights as W
from facerec_torch.models.facenet import FaceNetEmbedder
from facerec_torch.runtime.device import resolve_device


class WeightsNotFoundError(FileNotFoundError):
    """No usable weights found at the given location."""


def resolve_facenet_params(weights_dir: str, name: str) -> dict:
    """Load one FaceNet checkpoint by name from ``weights_dir`` as a
    Flax-shaped numpy tree, trying the formats in the module
    docstring's order."""
    pt = os.path.join(weights_dir, name + ".pt")
    if os.path.isfile(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):      # a whole module was saved
            sd = sd.state_dict()
        if "state_dict" in sd and isinstance(sd["state_dict"], dict):
            sd = sd["state_dict"]
        return W.facenet_params_from_torch(sd)

    h5 = os.path.join(weights_dir, name + ".h5")
    if os.path.isfile(h5):
        return W.facenet_params_from_keras_h5(h5)

    npz = os.path.join(weights_dir, name + ".npz")
    if os.path.isfile(npz):
        return convert.load_flax_npz(npz)

    sub = os.path.join(weights_dir, name)
    if os.path.isdir(sub):
        model_h5 = os.path.join(sub, "model.h5")
        if os.path.isfile(model_h5):
            return W.facenet_params_from_keras_h5(model_h5)
        raise NotImplementedError(
            f"{sub!r} looks like an orbax checkpoint, which the port "
            f"cannot read without JAX; export it with "
            f"facerec_tpu.models.weights.save_params_npz to "
            f"{npz!r}")

    raise WeightsNotFoundError(
        f"No weights for FaceNet checkpoint '{name}' under "
        f"{weights_dir!r} (tried {name}.pt, {name}.h5, {name}.npz, "
        f"{name}/model.h5)")


def load_facenet_embedders(weights_dir: str,
                           names: Sequence[str] = FACENET_MODELS,
                           device=None, missing_ok: bool = True
                           ) -> Dict[str, FaceNetEmbedder]:
    """name → FaceNetEmbedder with imported weights, for every name, on
    the card unless ``device="cpu"`` is asked for.

    A partial weights dir is usable: a missing name other than
    ``EMB_NAME`` gets random weights (seed = its position) with the
    loud :func:`warn_random_init` warning.  A dir where no name
    resolves raises (a wrong path), a dir without ``EMB_NAME`` raises,
    and ``missing_ok=False`` raises on any missing name.
    """
    device = resolve_device(device)
    found, missing = {}, []
    for name in names:
        try:
            found[name] = resolve_facenet_params(weights_dir, name)
        except WeightsNotFoundError:
            if not missing_ok:
                raise
            missing.append(name)
    if names and not found:
        raise WeightsNotFoundError(
            f"No FaceNet checkpoint of {list(names)} found under "
            f"{weights_dir!r} — wrong --facenet-weights path?")
    if EMB_NAME in missing:
        raise WeightsNotFoundError(
            f"FaceNet checkpoint '{EMB_NAME}' is missing from "
            f"{weights_dir!r}; cluster and classify read only that "
            f"embedding, so it cannot be random")

    out = {}
    for i, name in enumerate(names):
        if name in found:
            state = convert.facenet_state_dict(found[name],
                                               FACENET_DIMS[name])
            out[name] = FaceNetEmbedder(name, FACENET_DIMS[name], device,
                                        state_dict=state)
        else:
            warn_random_init(
                f"FaceNet checkpoint '{name}'",
                f"a {name}.pt/.h5/.npz in {weights_dir!r}")
            out[name] = FaceNetEmbedder(name, FACENET_DIMS[name], device,
                                        seed=i)
    return out


_WARNED: set = set()


def warn_random_init(what: str, flag: str) -> None:
    """Loud, once-per-process warning (or hard error) on random-weight
    models reaching a production path.

    Set ``FACEREC_REQUIRE_WEIGHTS=1`` to turn this into an error, or
    ``FACEREC_ALLOW_RANDOM=1`` to silence it (tests, smoke runs).
    """
    if os.environ.get("FACEREC_ALLOW_RANDOM") == "1" or what in _WARNED:
        return
    _WARNED.add(what)
    msg = (f"{what} is running with RANDOM weights — detections/"
           f"embeddings are meaningless. Pass {flag} to load pretrained "
           f"parameters.")
    if os.environ.get("FACEREC_REQUIRE_WEIGHTS") == "1":
        raise RuntimeError(msg)
    bar = "!" * 72
    print(f"{bar}\nWARNING: {msg}\n{bar}", flush=True)
