"""The port's FaceNet weight import (``models/weights.py``,
``models/load.py``) against the JAX package's, on the CPU.

Synthetic full-architecture checkpoints stand in for real downloads:
facenet-pytorch state dicts built by inverting the name mapping
(``tests/test_weights.py:fake_torch_state_dict``), saved as ``.pt``, and
the same weights written as a keras-facenet ``.h5`` and as the JAX
package's single-file ``.npz``.  Every route must give exactly the
``state_dict`` that ``convert.facenet_state_dict`` makes of the JAX
package's own import; the loaded net embeds within 1e-4 of the JAX
``FaceNetEmbedder`` (the FaceNet tolerance of ``test_torch_facenet.py``).
"""
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_tpu.models import FaceNetEmbedder as JaxEmbedder
from facerec_tpu.models import weights as JW
from tests.test_weights import fake_torch_state_dict

from facerec_torch.config import EMB_NAME, FACENET_MODELS, ExtractConfig
from facerec_torch.models import convert
from facerec_torch.models import load as L
from facerec_torch.models.facenet import FaceNetEmbedder
from facerec_torch.pipeline import extract
from facerec_torch.video.synth import ScriptedDetector, make_frames

EMB_ATOL = 1e-4
OTHER_128 = "20170511-185253"          # the other 128-d checkpoint


@pytest.fixture(scope="module")
def template():
    return JaxEmbedder("t", 128).variables


@pytest.fixture(scope="module")
def weights(template, tmp_path_factory):
    """Two 128-d checkpoints as facenet-pytorch ``.pt`` files, and the
    JAX package's import of each (the expected trees)."""
    d = tmp_path_factory.mktemp("weights")
    rng = np.random.default_rng(7)
    sds, want = {}, {}
    for name in (EMB_NAME, OTHER_128):
        sd = fake_torch_state_dict(template, rng)
        torch.save({k: torch.tensor(v) for k, v in sd.items()},
                   str(d / f"{name}.pt"))
        sds[name] = sd
        want[name] = JW.facenet_params_from_torch(sd, template)
    return str(d), sds, want


def write_keras_h5(path, sd):
    """The keras-facenet layout of ``tests/test_weights.py``."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")

        def put(layer, wname, arr):
            g.create_dataset(f"{layer}/{layer}/{wname}:0", data=arr)

        for ours, theirs in JW.convbn_module_map().items():
            conv_l, bn_l = JW._keras_layer_name(ours)
            put(conv_l, "kernel",
                sd[f"{theirs}.conv.weight"].transpose(2, 3, 1, 0))
            put(bn_l, "beta", sd[f"{theirs}.bn.bias"])
            put(bn_l, "moving_mean", sd[f"{theirs}.bn.running_mean"])
            put(bn_l, "moving_variance",
                JW.fold_bn_gamma(sd[f"{theirs}.bn.weight"],
                                 sd[f"{theirs}.bn.running_var"]))
        for ours, theirs in JW.up_conv_map().items():
            conv_l, _ = JW._keras_layer_name(ours)
            put(conv_l, "kernel", sd[f"{theirs}.weight"].transpose(2, 3, 1, 0))
            put(conv_l, "bias", sd[f"{theirs}.bias"])
        put("Bottleneck", "kernel", sd["last_linear.weight"].T)
        put("Bottleneck_BatchNorm", "beta", sd["last_bn.bias"])
        put("Bottleneck_BatchNorm", "moving_mean", sd["last_bn.running_mean"])
        put("Bottleneck_BatchNorm", "moving_variance",
            JW.fold_bn_gamma(sd["last_bn.weight"], sd["last_bn.running_var"]))


def assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("layout", ["pt", "h5", "model_h5", "npz"])
def test_every_format_loads_the_jax_import_exactly(weights, tmp_path, layout):
    d, sds, want = weights
    name = EMB_NAME
    src = str(tmp_path / "w")
    os.makedirs(src)
    if layout == "pt":
        shutil.copy(os.path.join(d, f"{name}.pt"), src)
    elif layout == "h5":
        write_keras_h5(os.path.join(src, f"{name}.h5"), sds[name])
    elif layout == "model_h5":
        os.makedirs(os.path.join(src, name))
        write_keras_h5(os.path.join(src, name, "model.h5"), sds[name])
    else:
        JW.save_params_npz(os.path.join(src, f"{name}.npz"), want[name])
    got = convert.facenet_state_dict(L.resolve_facenet_params(src, name), 128)
    assert_state_equal(got, convert.facenet_state_dict(want[name]))


def test_h5_without_h5py_names_the_file(weights, tmp_path, monkeypatch):
    _, sds, _ = weights
    path = str(tmp_path / f"{EMB_NAME}.h5")
    write_keras_h5(path, sds[EMB_NAME])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=f"{EMB_NAME}.h5"):
        L.resolve_facenet_params(str(tmp_path), EMB_NAME)


def test_orbax_directory_names_the_npz_alternative(tmp_path):
    (tmp_path / EMB_NAME).mkdir()
    with pytest.raises(NotImplementedError, match=r"\.npz"):
        L.resolve_facenet_params(str(tmp_path), EMB_NAME)


def test_wrong_width_under_a_name_raises(weights, tmp_path):
    """A 128-d checkpoint saved under a 512-d name."""
    d, _, _ = weights
    shutil.copy(os.path.join(d, f"{EMB_NAME}.pt"),
                tmp_path / f"{FACENET_MODELS[0]}.pt")
    shutil.copy(os.path.join(d, f"{EMB_NAME}.pt"), tmp_path)
    with pytest.raises(ValueError, match="expected 512"):
        L.load_facenet_embedders(str(tmp_path), device="cpu")


def test_missing_names_empty_dirs_and_required_weights(weights, tmp_path,
                                                       monkeypatch, capsys):
    """EMB_NAME missing raises (unlike the JAX package); an empty dir
    raises; other missing names get the loud random init, which
    FACEREC_REQUIRE_WEIGHTS=1 turns into an error."""
    d, _, want = weights
    monkeypatch.delenv("FACEREC_ALLOW_RANDOM", raising=False)
    monkeypatch.delenv("FACEREC_REQUIRE_WEIGHTS", raising=False)
    no_emb = tmp_path / "no_emb"
    no_emb.mkdir()
    shutil.copy(os.path.join(d, f"{OTHER_128}.pt"), no_emb)
    with pytest.raises(L.WeightsNotFoundError, match=EMB_NAME):
        L.load_facenet_embedders(str(no_emb), device="cpu")
    with pytest.raises(L.WeightsNotFoundError, match="wrong"):
        L.load_facenet_embedders(str(tmp_path / "nothing_here"),
                                  device="cpu")

    only_emb = tmp_path / "only_emb"
    only_emb.mkdir()
    shutil.copy(os.path.join(d, f"{EMB_NAME}.pt"), only_emb)
    monkeypatch.setattr(L, "_WARNED", set())
    bank = L.load_facenet_embedders(str(only_emb), device="cpu")
    assert list(bank) == list(FACENET_MODELS)
    warned = capsys.readouterr().out
    assert all(n in warned for n in FACENET_MODELS if n != EMB_NAME)
    assert_state_equal(bank[EMB_NAME].model.state_dict(),
                       convert.facenet_state_dict(want[EMB_NAME]))
    with pytest.raises(L.WeightsNotFoundError):
        L.load_facenet_embedders(str(only_emb), device="cpu",
                                  missing_ok=False)
    monkeypatch.setenv("FACEREC_REQUIRE_WEIGHTS", "1")
    monkeypatch.setattr(L, "_WARNED", set())
    with pytest.raises(RuntimeError, match="RANDOM"):
        L.load_facenet_embedders(str(only_emb), device="cpu")


def test_loaded_net_embeds_as_the_jax_embedder(weights):
    d, _, want = weights
    crops = np.random.default_rng(0).integers(
        0, 256, (2, 160, 160, 3)).astype(np.uint8)
    (emb,) = L.load_facenet_embedders(d, names=(EMB_NAME,),
                                      device="cpu").values()
    got = emb(torch.from_numpy(crops)).numpy()
    ref = np.asarray(JaxEmbedder(EMB_NAME, 128, params=want[EMB_NAME])(
        jnp.asarray(crops)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=EMB_ATOL)


def test_run_extract_embeds_with_the_weights_dir(weights, tmp_path,
                                                 monkeypatch):
    """``facenet_weights=dir`` reaches the EMB_NAME net: its features
    equal those of a bank built from the JAX package's import."""
    d, _, want = weights
    only_emb = tmp_path / "w"
    only_emb.mkdir()
    shutil.copy(os.path.join(d, f"{EMB_NAME}.pt"), only_emb)
    monkeypatch.setenv("FACEREC_ALLOW_RANDOM", "1")
    clip = make_frames(10, cuts=(), seed=5, path="125261-Weights.mp4")
    cfg = ExtractConfig(block_frames=16, max_detections=8, max_tracks=16,
                        save_images=False, resume=False)
    direct = extract.EmbedderBank({EMB_NAME: FaceNetEmbedder(
        EMB_NAME, 128, "cpu", state_dict=convert.facenet_state_dict(
            want[EMB_NAME]))})
    feats = {}
    for key, kw in (("dir", dict(facenet_weights=str(only_emb))),
                    ("direct", dict(embedders=direct))):
        out = str(tmp_path / key)
        extract.run_extract(clip, cfg, out,
                            detector=ScriptedDetector(clip, max_detections=8),
                            device="cpu", **kw)
        path = os.path.join(out, "125261-data", "features",
                            "features_125261_0-10.jsonl")
        feats[key] = [json.loads(l) for l in open(path)]
    assert feats["dir"] and len(feats["dir"]) == len(feats["direct"])
    for a, b in zip(feats["dir"], feats["direct"]):
        assert list(a["embeddings"]) == list(FACENET_MODELS)
        np.testing.assert_allclose(a["embeddings"][EMB_NAME],
                                   b["embeddings"][EMB_NAME], rtol=0,
                                   atol=1e-6)


def test_extract_cli_passes_the_weights_flag(monkeypatch):
    seen = {}
    monkeypatch.setattr(extract, "run_extract",
                        lambda *a, **kw: seen.update(kw))
    extract.main(["--device", "cpu", "--facenet-weights", "/w",
                  "125261-x.mp4"])
    assert seen["facenet_weights"] == "/w" and seen["device"] == "cpu"
