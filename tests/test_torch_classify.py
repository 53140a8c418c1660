"""The port's classification (``ops/knn.py``, ``pipeline/classify.py``)
against the JAX package's, on the CPU.

Classes are equal and probabilities within 1e-6 (a mean is a division,
so bits are not asserted); neighbour ties, which upsampled training
sets make routine, resolve toward the lower training index in both.
``predictions.json`` is byte-identical on the same directory, actor zip
and config.
"""
import json
import os
import shutil
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_tpu.config import ClassifyConfig as JaxClassifyConfig
from facerec_tpu.config import ClusterConfig as JaxClusterConfig
from facerec_tpu.ops import knn as jax_knn
from facerec_tpu.pipeline import classify as jax_classify
from facerec_tpu.pipeline.cluster import run_cluster as jax_run_cluster
from tests.test_torch_cluster import merged_dir  # noqa: F401 (fixture)

from facerec_torch.config import ClassifyConfig
from facerec_torch.ops import knn
from facerec_torch.pipeline import classify

PROBA_ATOL = 1e-6
MOVIE = 125261


def assert_knn_matches(x, y, q, k):
    want_p, want_c = jax_knn.knn_predict_proba(x, y, q, k)
    got_p, got_c = knn.knn_predict_proba(x, y, q, k, "cpu")
    np.testing.assert_array_equal(got_c, want_c)
    assert got_p.dtype == np.float32 and got_p.shape == want_p.shape
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=PROBA_ATOL)


@pytest.mark.parametrize("m,q,k,n_classes", [(60, 20, 10, 5), (12, 7, 1, 3),
                                             (30, 50, 30, 4)])
def test_knn_matches_jax(m, q, k, n_classes):
    rng = np.random.default_rng(m + q)
    x = rng.normal(size=(m, 16)).astype(np.float32)
    y = rng.integers(0, n_classes, m) * 7 + 3      # arbitrary class ids
    assert_knn_matches(x, y, rng.normal(size=(q, 16)).astype(np.float32), k)


def test_knn_on_an_upsampled_training_set():
    """build_training_set repeats each actor's vectors: every query has
    runs of exactly equal distances, cut at the k-th neighbour."""
    rng = np.random.default_rng(3)
    emb = [(500 + a, (rng.normal(size=8) + a).tolist())
           for a in range(4) for _ in range(a + 1)]
    want = jax_classify.build_training_set(emb, min_samples=7)
    x, y = classify.build_training_set(emb, min_samples=7)
    np.testing.assert_array_equal(x, want[0])
    np.testing.assert_array_equal(y, want[1])
    assert len(np.unique(x, axis=0)) < len(x)
    q = np.concatenate([x[::5], rng.normal(size=(6, 8)).astype(np.float32)])
    for k in (3, 7, 10):
        assert_knn_matches(x, y, q, k)


def test_knn_tie_across_classes_at_the_kth_neighbour():
    """Rows 1 and 2 are the same vector under two classes; with k=2 the
    query's second neighbour is a tie between them, broken toward the
    lower index (class 11, not 22)."""
    x = np.array([[0, 0], [1, 0], [1, 0], [5, 5]], np.float32)
    y = np.array([10, 11, 22, 33])
    q = np.zeros((1, 2), np.float32)
    assert_knn_matches(x, y, q, 2)
    proba, classes = knn.knn_predict_proba(x, y, q, 2, "cpu")
    assert dict(zip(classes.tolist(), proba[0].tolist())) == {
        10: 0.5, 11: 0.5, 22: 0.0, 33: 0.0}
    d2 = knn.squared_distances(torch.from_numpy(q), torch.from_numpy(x))
    assert knn.nearest(d2, 3).tolist() == [[0, 1, 2]]


def test_knn_k_too_large_and_empty_query():
    x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    y = np.arange(5)
    with pytest.raises(ValueError, match="n_neighbors"):
        knn.knn_predict_proba(x, y, x, 10, "cpu")
    proba, classes = knn.knn_predict_proba(x, y, x[:0], 10, "cpu")
    want_p, want_c = jax_knn.knn_predict_proba(x, y, x[:0], 10)
    assert proba.shape == want_p.shape == (0, 5)
    np.testing.assert_array_equal(classes, want_c)


def write_actor_zip(path, features_path, emb_name, n_actors=3, per=3):
    """The recipe of tests/test_extract_e2e.py: actors placed near the
    run's own embeddings."""
    feats = [json.loads(l) for l in open(features_path)]
    rng = np.random.default_rng(0)
    with zipfile.ZipFile(path, "w") as z:
        for a in range(n_actors):
            base = np.array(feats[min(a, len(feats) - 1)]
                            ["embeddings"][emb_name])
            for i in range(per):
                vec = (base + rng.normal(size=base.size) * 0.01).tolist()
                z.writestr(f"a{a}_{i}.json", json.dumps({
                    "box": [0, 0, 1, 1], "embeddings": {emb_name: vec},
                    "actorID": str(500 + a), "actorname": f"A{a}"}))
            z.writestr(f"a{a}_none.json", json.dumps({"note": "no face"}))
    return str(path)


@pytest.fixture
def clustered(merged_dir, tmp_path):  # noqa: F811
    d = shutil.copytree(merged_dir, tmp_path / "base" / f"{MOVIE}-data")
    jax_run_cluster(str(d), JaxClusterConfig(size=2, min_size=1, max_size=4,
                                             emb_name="m1"))
    return str(d)


@pytest.mark.parametrize("n_actors", [3, 2])
def test_run_classify_byte_identical(clustered, tmp_path, n_actors):
    """3 actors: the KNN path; 2 actors: the too-few-classes path and
    its bare ``{cluster: {}}`` file."""
    zpath = write_actor_zip(tmp_path / "actor-images.zip",
                            os.path.join(clustered, "features.jsonl"), "m1",
                            n_actors=n_actors)
    want_e = jax_classify.read_actor_embeddings(zpath, "m1")
    got_e = classify.read_actor_embeddings(zpath, "m1")
    assert got_e == want_e
    outs = {}
    for who in ("jax", "port"):
        d = shutil.copytree(clustered, tmp_path / who / f"{MOVIE}-data")
        if who == "jax":
            x, y = jax_classify.build_training_set(want_e[0], min_samples=3)
            jax_classify.run_classify(str(d), x, y,
                                      JaxClassifyConfig(k=3, emb_name="m1"))
        else:
            x, y = classify.build_training_set(got_e[0], min_samples=3)
            classify.run_classify(str(d), x, y,
                                  ClassifyConfig(k=3, emb_name="m1"), "cpu")
        outs[who] = open(os.path.join(d, "predictions.json"), "rb").read()
    assert outs["port"] == outs["jax"]
    preds = json.loads(outs["port"])
    if n_actors == 3:
        assert preds["movie_id"] == MOVIE and preds["predictions"]
    else:
        assert all(v == {} for v in preds.values())


def test_run_classify_refuses_k_above_the_training_set(clustered):
    x = np.zeros((4, 16), np.float32)
    y = np.array([1, 2, 3, 4])
    with pytest.raises(ValueError, match="k=10"):
        classify.run_classify(clustered, x, y, ClassifyConfig(emb_name="m1"),
                              "cpu")


def test_classify_cli_reads_the_first_dir_only(clustered, tmp_path):
    """``main`` stops after the first matching directory, as the
    reference does; it writes the default-config predictions."""
    zpath = write_actor_zip(tmp_path / "actor-images.zip",
                            os.path.join(clustered, "features.jsonl"), "m1")
    with zipfile.ZipFile(zpath) as z:
        names = z.namelist()
    # the default config reads EMB_NAME: copies whose EMB_NAME vector
    # is the 16-d m1 vector tiled 8 times (128 dims)
    from facerec_torch.config import EMB_NAME
    actors = tmp_path / "actors"
    actors.mkdir()
    with zipfile.ZipFile(zpath) as z, \
            zipfile.ZipFile(actors / "actor-images.zip", "w") as out:
        for n in names:
            d = json.loads(z.read(n))
            if "embeddings" in d:
                d["embeddings"] = {EMB_NAME: d["embeddings"]["m1"] * 8}
            out.writestr(n, json.dumps(d))
    d = tmp_path / "run" / f"{MOVIE}-data"
    shutil.copytree(clustered, d)
    feats = [json.loads(l) for l in open(d / "features.jsonl")]
    with open(d / "features.jsonl", "w") as f:
        for r in feats:
            r["embeddings"][EMB_NAME] = r["embeddings"]["m1"] * 8
            f.write(json.dumps(r) + "\n")
    shutil.copytree(d, tmp_path / "run" / f"{MOVIE + 1}-data")
    classify.main(["--path", str(tmp_path / "run" / "*-data"),
                   "--actors-dir", str(actors), "--device", "cpu"])
    written = [p for p in (tmp_path / "run").glob("*-data/predictions.json")]
    assert len(written) == 1
    preds = json.loads(written[0].read_text())
    assert preds["movie_id"] in (MOVIE, MOVIE + 1) and preds["predictions"]


def test_squared_distances_match_jax_form():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(20, 16)).astype(np.float32)
    q = rng.normal(size=(9, 16)).astype(np.float32)
    want = (np.sum(q * q, -1)[:, None] - 2.0 * np.asarray(
        jnp.asarray(q) @ jnp.asarray(x).T) + np.sum(x * x, -1)[None])
    got = knn.squared_distances(torch.from_numpy(q),
                                torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
