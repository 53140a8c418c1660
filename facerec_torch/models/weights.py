"""FaceNet weight import from the two public formats users have on disk.

Port of the FaceNet import half of ``facerec_tpu/models/weights.py``:

  - ``facenet-pytorch`` ``InceptionResnetV1`` state dicts (.pt) — the
    same davidsandberg architecture; batch-norm γ is folded into the
    running variance, since the model's inference batch norm is
    scale-free like the TF original.
  - keras-facenet .h5 model files — TF layer names map 1:1 onto the
    model's module names.

Both build the JAX package's Flax-shaped tree of numpy arrays
(``{"params": ..., "batch_stats": ...}``), which
:func:`facerec_torch.models.convert.facenet_state_dict` turns into the
port's ``state_dict``; that step rejects a missing or extra leaf and a
wrong shape, so a silently partial import is impossible.  ``h5py`` is
imported only to read a ``.h5`` file.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np

BN_EPS = 1e-3

Path = Tuple[str, ...]


def _unflatten(flat: Dict[Path, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return root


# the model's ConvBN module ← facenet-pytorch BasicConv2d module
_STEM = {
    "Conv2d_1a_3x3": "conv2d_1a",
    "Conv2d_2a_3x3": "conv2d_2a",
    "Conv2d_2b_3x3": "conv2d_2b",
    "Conv2d_3b_1x1": "conv2d_3b",
    "Conv2d_4a_3x3": "conv2d_4a",
    "Conv2d_4b_3x3": "conv2d_4b",
    "Mixed_6a_Branch_0_Conv2d_1a_3x3": "mixed_6a.branch0",
    "Mixed_6a_Branch_1_Conv2d_0a_1x1": "mixed_6a.branch1.0",
    "Mixed_6a_Branch_1_Conv2d_0b_3x3": "mixed_6a.branch1.1",
    "Mixed_6a_Branch_1_Conv2d_1a_3x3": "mixed_6a.branch1.2",
    "Mixed_7a_Branch_0_Conv2d_0a_1x1": "mixed_7a.branch0.0",
    "Mixed_7a_Branch_0_Conv2d_1a_3x3": "mixed_7a.branch0.1",
    "Mixed_7a_Branch_1_Conv2d_0a_1x1": "mixed_7a.branch1.0",
    "Mixed_7a_Branch_1_Conv2d_1a_3x3": "mixed_7a.branch1.1",
    "Mixed_7a_Branch_2_Conv2d_0a_1x1": "mixed_7a.branch2.0",
    "Mixed_7a_Branch_2_Conv2d_0b_3x3": "mixed_7a.branch2.1",
    "Mixed_7a_Branch_2_Conv2d_1a_3x3": "mixed_7a.branch2.2",
}

_BLOCK_BRANCHES = {
    "block35": {
        "Branch_0_Conv2d_1x1": "branch0",
        "Branch_1_Conv2d_0a_1x1": "branch1.0",
        "Branch_1_Conv2d_0b_3x3": "branch1.1",
        "Branch_2_Conv2d_0a_1x1": "branch2.0",
        "Branch_2_Conv2d_0b_3x3": "branch2.1",
        "Branch_2_Conv2d_0c_3x3": "branch2.2",
    },
    "block17": {
        "Branch_0_Conv2d_1x1": "branch0",
        "Branch_1_Conv2d_0a_1x1": "branch1.0",
        "Branch_1_Conv2d_0b_1x7": "branch1.1",
        "Branch_1_Conv2d_0c_7x1": "branch1.2",
    },
    "block8": {
        "Branch_0_Conv2d_1x1": "branch0",
        "Branch_1_Conv2d_0a_1x1": "branch1.0",
        "Branch_1_Conv2d_0b_1x3": "branch1.1",
        "Branch_1_Conv2d_0c_3x1": "branch1.2",
    },
}


def convbn_module_map() -> Dict[str, str]:
    """Full mapping: the model's ConvBN path → facenet-pytorch
    BasicConv2d path."""
    mapping = dict(_STEM)
    for i in range(5):
        for ours, theirs in _BLOCK_BRANCHES["block35"].items():
            mapping[f"Repeat_block35_{i + 1}/{ours}"] = \
                f"repeat_1.{i}.{theirs}"
    for i in range(10):
        for ours, theirs in _BLOCK_BRANCHES["block17"].items():
            mapping[f"Repeat_1_block17_{i + 1}/{ours}"] = \
                f"repeat_2.{i}.{theirs}"
    for i in range(5):
        for ours, theirs in _BLOCK_BRANCHES["block8"].items():
            mapping[f"Repeat_2_block8_{i + 1}/{ours}"] = \
                f"repeat_3.{i}.{theirs}"
    for ours, theirs in _BLOCK_BRANCHES["block8"].items():
        mapping[f"Block8/{ours}"] = f"block8.{theirs}"
    return mapping


def up_conv_map() -> Dict[str, str]:
    """The residual 'up' convs (kernel+bias, no BN)."""
    mapping = {}
    for i in range(5):
        mapping[f"Repeat_block35_{i + 1}/Conv2d_1x1"] = f"repeat_1.{i}.conv2d"
    for i in range(10):
        mapping[f"Repeat_1_block17_{i + 1}/Conv2d_1x1"] = \
            f"repeat_2.{i}.conv2d"
    for i in range(5):
        mapping[f"Repeat_2_block8_{i + 1}/Conv2d_1x1"] = f"repeat_3.{i}.conv2d"
    mapping["Block8/Conv2d_1x1"] = "block8.conv2d"
    return mapping


def fold_bn_gamma(gamma: np.ndarray, var: np.ndarray,
                  eps: float = BN_EPS) -> np.ndarray:
    """Fold an affine BN's γ into the running variance so a scale-free
    BN computes the same function: (x-μ)/√(v'+ε) == γ(x-μ)/√(v+ε) with
    v' = (v+ε)/γ² − ε."""
    return (var + eps) / (gamma * gamma) - eps


def _float32(arr) -> np.ndarray:
    return np.asarray(arr).astype(np.float32)


def facenet_params_from_torch(state_dict: Dict[str, Any]) -> dict:
    """facenet-pytorch ``InceptionResnetV1`` state dict (torch tensors
    or numpy arrays) → Flax-shaped tree of float32 numpy arrays."""
    def arr(name):
        v = state_dict[name]
        return v.detach().cpu().numpy() if hasattr(v, "detach") else \
            np.asarray(v)

    updates: Dict[Path, np.ndarray] = {}

    for ours, theirs in convbn_module_map().items():
        path = tuple(ours.split("/"))
        kernel = arr(f"{theirs}.conv.weight").transpose(2, 3, 1, 0)
        gamma = arr(f"{theirs}.bn.weight")
        beta = arr(f"{theirs}.bn.bias")
        mean = arr(f"{theirs}.bn.running_mean")
        var = arr(f"{theirs}.bn.running_var")
        updates[("params",) + path + ("Conv_0", "kernel")] = kernel
        updates[("params",) + path + ("BatchNorm_0", "bias")] = beta
        updates[("batch_stats",) + path + ("BatchNorm_0", "mean")] = mean
        updates[("batch_stats",) + path + ("BatchNorm_0", "var")] = \
            fold_bn_gamma(gamma, var)

    for ours, theirs in up_conv_map().items():
        path = tuple(ours.split("/"))
        updates[("params",) + path + ("kernel",)] = \
            arr(f"{theirs}.weight").transpose(2, 3, 1, 0)
        updates[("params",) + path + ("bias",)] = arr(f"{theirs}.bias")

    updates[("params", "Bottleneck", "kernel")] = \
        arr("last_linear.weight").T
    gamma = arr("last_bn.weight")
    updates[("params", "Bottleneck_BatchNorm", "bias")] = arr("last_bn.bias")
    updates[("batch_stats", "Bottleneck_BatchNorm", "mean")] = \
        arr("last_bn.running_mean")
    updates[("batch_stats", "Bottleneck_BatchNorm", "var")] = \
        fold_bn_gamma(gamma, arr("last_bn.running_var"))

    return _unflatten({p: _float32(v) for p, v in updates.items()})


def _keras_layer_name(ours: str) -> Tuple[str, str]:
    """(conv_layer, bn_layer) keras names for one of the model's ConvBN
    paths."""
    if ours.startswith("Repeat_block35_"):
        i = int(re.match(r"Repeat_block35_(\d+)/", ours).group(1))
        rest = ours.split("/", 1)[1]
        base = f"Block35_{i}_{rest}"
    elif ours.startswith("Repeat_1_block17_"):
        i = int(re.match(r"Repeat_1_block17_(\d+)/", ours).group(1))
        rest = ours.split("/", 1)[1]
        base = f"Block17_{i}_{rest}"
    elif ours.startswith("Repeat_2_block8_"):
        i = int(re.match(r"Repeat_2_block8_(\d+)/", ours).group(1))
        rest = ours.split("/", 1)[1]
        base = f"Block8_{i}_{rest}"
    elif ours.startswith("Block8/"):
        base = f"Block8_6_{ours.split('/', 1)[1]}"
    else:
        base = ours.replace("/", "_")
    return base, base + "_BatchNorm"


def facenet_params_from_keras_h5(h5_path: str) -> dict:
    """keras-facenet .h5 model file → Flax-shaped tree of float32 numpy
    arrays.  Raises ImportError naming the file where h5py is missing."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading {h5_path} needs h5py, which is not "
                          f"installed") from e

    weights: Dict[Tuple[str, str], np.ndarray] = {}
    with h5py.File(h5_path, "r") as f:
        group = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                parts = name.split("/")
                wname = parts[-1].split(":")[0]
                weights[(parts[-2], wname)] = np.array(obj)

        group.visititems(visit)

    updates: Dict[Path, np.ndarray] = {}
    for ours in convbn_module_map():
        path = tuple(ours.split("/"))
        conv_l, bn_l = _keras_layer_name(ours)
        updates[("params",) + path + ("Conv_0", "kernel")] = \
            weights[(conv_l, "kernel")]
        updates[("params",) + path + ("BatchNorm_0", "bias")] = \
            weights[(bn_l, "beta")]
        updates[("batch_stats",) + path + ("BatchNorm_0", "mean")] = \
            weights[(bn_l, "moving_mean")]
        updates[("batch_stats",) + path + ("BatchNorm_0", "var")] = \
            weights[(bn_l, "moving_variance")]
    for ours in up_conv_map():
        path = tuple(ours.split("/"))
        conv_l, _ = _keras_layer_name(ours)
        updates[("params",) + path + ("kernel",)] = weights[(conv_l, "kernel")]
        updates[("params",) + path + ("bias",)] = weights[(conv_l, "bias")]

    updates[("params", "Bottleneck", "kernel")] = \
        weights[("Bottleneck", "kernel")]
    updates[("params", "Bottleneck_BatchNorm", "bias")] = \
        weights[("Bottleneck_BatchNorm", "beta")]
    updates[("batch_stats", "Bottleneck_BatchNorm", "mean")] = \
        weights[("Bottleneck_BatchNorm", "moving_mean")]
    updates[("batch_stats", "Bottleneck_BatchNorm", "var")] = \
        weights[("Bottleneck_BatchNorm", "moving_variance")]

    return _unflatten({p: _float32(v) for p, v in updates.items()})
