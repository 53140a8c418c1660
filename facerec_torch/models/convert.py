"""Carry weights from the JAX package's Flax trees into the port.

The Flax variables ``{"params": ..., "batch_stats": ...}`` (nested
dicts of numpy arrays) map onto the port modules' ``state_dict`` by
name: ``Conv_0``/``BatchNorm_0`` become ``conv``/``bn``, path segments
join with ``.``, Flax ``kernel`` becomes ``weight`` (HWIO → OIHW for a
convolution, (in, out) → (out, in) for a dense layer), and batch
statistics ``mean``/``var`` keep their names.  A missing or extra key,
or a wrong shape, raises.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_RENAME = {"Conv_0": "conv", "BatchNorm_0": "bn"}


def flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested dicts → {path tuple: leaf array}."""
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _torch_key(path: Tuple[str, ...]) -> str:
    collection, *mods, leaf = path
    if collection not in ("params", "batch_stats"):
        raise KeyError(f"unknown Flax collection in {'/'.join(path)}")
    name = {"kernel": "weight"}.get(leaf, leaf)
    return ".".join([_RENAME.get(m, m) for m in mods] + [name])


def _torch_value(leaf: str, arr: np.ndarray) -> torch.Tensor:
    if leaf == "kernel" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)          # HWIO → OIHW
    elif leaf == "kernel" and arr.ndim == 2:
        arr = arr.T                              # (in, out) → (out, in)
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def state_dict_from_flax(module: torch.nn.Module,
                         flax_vars: Mapping) -> Dict[str, torch.Tensor]:
    """``module``'s state_dict filled from a Flax variables tree."""
    want = module.state_dict()
    got: Dict[str, torch.Tensor] = {}
    for path, arr in flatten(flax_vars).items():
        key = _torch_key(path)
        if key in got:
            raise KeyError(f"two Flax leaves map to {key}")
        got[key] = _torch_value(path[-1], arr)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"Flax tree does not match {type(module).__name__}: "
                       f"missing {missing[:5]}, extra {extra[:5]}")
    for k, v in got.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                             f"{tuple(want[k].shape)}")
    return got


def detector_state_dict(flax_vars_numpy: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """State dict of a :class:`~facerec_torch.models.detector.FaceDetector`
    of the tree's width (read from the stem kernel)."""
    from facerec_torch.models.detector import FaceDetector

    width = int(np.asarray(
        flax_vars_numpy["params"]["stem"]["Conv_0"]["kernel"]).shape[-1])
    return state_dict_from_flax(FaceDetector(backbone_width=width),
                                flax_vars_numpy)


def facenet_state_dict(flax_vars_numpy: Mapping,
                       embedding_dim: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """State dict of a :class:`~facerec_torch.models.facenet.FaceNet`
    of the tree's bottleneck size; with ``embedding_dim``, a tree of
    another size raises (a checkpoint under the wrong name)."""
    from facerec_torch.models.facenet import FaceNet

    dim = int(np.asarray(
        flax_vars_numpy["params"]["Bottleneck"]["kernel"]).shape[-1])
    if embedding_dim is not None and dim != embedding_dim:
        raise ValueError(f"FaceNet weights embed to {dim} dims, "
                         f"expected {embedding_dim}")
    return state_dict_from_flax(FaceNet(dim), flax_vars_numpy)


_FLAX_NAME = {v: k for k, v in _RENAME.items()}


def flax_leaves(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """``module``'s state as the JAX package's flat checkpoint leaves,
    the inverse of :func:`state_dict_from_flax`: ``/``-joined Flax paths
    under ``params`` (parameters) or ``batch_stats`` (buffers), OIHW →
    HWIO and (out, in) → (in, out) kernels."""
    buffers = {k for k, _ in module.named_buffers()}
    out = {}
    for key, t in module.state_dict().items():
        *mods, leaf = key.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)      # OIHW → HWIO
            elif arr.ndim == 2:
                arr = arr.T                          # (out, in) → (in, out)
        collection = "batch_stats" if key in buffers else "params"
        path = [collection] + [_FLAX_NAME.get(m, m) for m in mods] + [leaf]
        out["/".join(path)] = np.ascontiguousarray(arr)
    return out


def save_params_npz(path: str, module: torch.nn.Module, cast=None) -> None:
    """Write ``module`` as ONE compressed single-file Flax checkpoint,
    the layout of ``facerec_tpu/models/weights.py:save_params_npz``: it
    loads in the JAX package's ``load_params_npz``, in
    :meth:`~facerec_torch.models.detector.DetectorHarness.from_npz` and,
    as ``<dir>/<name>.npz``, in
    :func:`~facerec_torch.models.load.resolve_facenet_params`.  ``cast``
    (e.g. ``np.float16``) casts the floating leaves."""
    leaves = flax_leaves(module)
    if cast is not None:
        leaves = {k: v.astype(cast) if np.issubdtype(v.dtype, np.floating)
                  else v for k, v in leaves.items()}
    np.savez_compressed(path, **leaves)


def load_flax_npz(path: str) -> Dict:
    """Read a single-file Flax checkpoint (the ``/``-joined flat
    ``.npz`` of ``facerec_tpu/models/weights.py:save_params_npz``) into
    nested dicts of float32/int numpy arrays, with numpy alone."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            arr = data[key]
            if np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float32)
            node[leaf] = arr
    return tree
