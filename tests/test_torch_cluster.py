"""The port's clustering (``ops/linkage.py``, ``pipeline/cluster.py``)
against the JAX package's, on the CPU.

Distances agree within 1e-3 (the matrix-product form in float32, the
JAX test's own remark); fed the same distance matrix, both merge loops
record the identical sequence; labels, the size repair and
``clusters.json`` are identical.  The ``(9, 0)`` case is held against
the JAX package, not scipy: with t=0 the two disagree.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerec_tpu.config import ClusterConfig as JaxClusterConfig
from facerec_tpu.config import ExtractConfig as JaxExtractConfig
from facerec_tpu.config import MergeConfig as JaxMergeConfig
from facerec_tpu.ops import linkage as jax_linkage
from facerec_tpu.pipeline import cluster as jax_cluster
from facerec_tpu.pipeline.extract import run_extract as jax_run_extract
from facerec_tpu.pipeline.merge import run_merge as jax_run_merge
from facerec_tpu.video.synth import ScriptedDetector as JaxScriptedDetector
from facerec_tpu.video.synth import make_clip as jax_make_clip
from tests.test_extract_e2e import StubEmbedderBank as JaxStubBank

from facerec_torch.config import ClusterConfig
from facerec_torch.ops import linkage
from facerec_torch.pipeline import cluster

DIST_ATOL = 1e-3
MOVIE = 125261


def jax_merges(dist):
    return np.asarray(jax_linkage.complete_linkage_merges(jnp.asarray(dist)))


def port_merges(dist):
    return linkage.complete_linkage_merges(
        torch.from_numpy(np.array(dist))).numpy()


@pytest.mark.parametrize("n,dim", [(2, 8), (12, 5), (40, 16)])
def test_pairwise_distances_match_jax(n, dim):
    """Off the diagonal within 1e-3.  On it the exact distance is 0, and
    the sqrt magnifies each package's own rounding of |x|² − 2x·x + |x|²
    (a few float32 ulps of 2|x|²), so each diagonal is held to
    sqrt(4 ulps) instead of to the other's."""
    x = np.random.default_rng(n).normal(size=(n, dim)).astype(np.float32)
    want = np.asarray(jax_linkage.pairwise_distances(jnp.asarray(x)))
    got = linkage.pairwise_distances(torch.from_numpy(x)).numpy()
    off = ~np.eye(n, dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=0, atol=DIST_ATOL)
    assert got.dtype == np.float32
    bound = np.sqrt(4 * np.finfo(np.float32).eps * 2 * np.sum(x * x, -1))
    for d in (got, want):
        assert np.all((np.diag(d) >= 0) & (np.diag(d) <= bound))


@pytest.mark.parametrize("n", [2, 3, 17, 64])
def test_merges_identical_on_the_same_matrix(n):
    """Both loops fed one float32 matrix (computed once, in float64)."""
    x = np.random.default_rng(100 + n).normal(size=(n, 8))
    dist = np.linalg.norm(x[:, None] - x[None], axis=-1).astype(np.float32)
    want = jax_merges(dist)
    got = port_merges(dist)
    assert got.shape == (n - 1, 2)
    np.testing.assert_array_equal(got, want)


def test_merges_identical_on_exact_duplicates():
    """Exact duplicate vectors: on one exactly tied matrix (0 between
    duplicates) both loops take the first minimum in row-major order,
    and on the JAX package's own matrix too.  Labels agree wherever the
    cut lies above the duplicates (k up to the 6 distinct vectors);
    below it, each package splits duplicates by the rounding of its own
    matrix product (distances of 0 to ~1e-3), so k > 6 is not held
    across packages."""
    base = np.random.default_rng(5).normal(size=(6, 8)).astype(np.float32)
    x = np.concatenate([base, base, base[:3], base[:1]])
    exact = np.linalg.norm(x[:, None].astype(np.float64) - x[None],
                           axis=-1).astype(np.float32)
    assert np.sum(exact == 0) > len(x)
    for dist in (exact,
                 np.asarray(jax_linkage.pairwise_distances(jnp.asarray(x)))):
        np.testing.assert_array_equal(port_merges(dist), jax_merges(dist))
    for k in (1, 3, 5, 6):
        np.testing.assert_array_equal(
            linkage.cluster_vectors(x, k, "cpu"),
            jax_linkage.cluster_vectors(x, k))


@pytest.mark.parametrize("n,k", [(10, 3), (50, 5), (120, 7), (40, 1),
                                 (7, 7), (30, 29), (9, 0), (13, 30)])
def test_cluster_vectors_labels_identical(rng, n, k):
    x = rng.normal(size=(n, 8)).astype(np.float32)
    np.testing.assert_array_equal(linkage.cluster_vectors(x, k, "cpu"),
                                  jax_linkage.cluster_vectors(x, k))


def test_cluster_vectors_edge_sizes():
    for n in (0, 1):
        x = np.zeros((n, 4), np.float32)
        np.testing.assert_array_equal(linkage.cluster_vectors(x, 1, "cpu"),
                                      jax_linkage.cluster_vectors(x, 1))


@pytest.mark.parametrize("labels", [
    [0] * 60 + [1] * 15 + [2, 3, 4, 5] * 2,
    [3, 3, 1, 7, 7, 7, 2, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9],
    list(range(12)),
])
def test_split_and_merge_and_relabel_identical(labels):
    labels = np.array(labels)
    np.testing.assert_array_equal(
        cluster.split_and_merge(labels.copy(), 4, 6),
        jax_cluster.split_and_merge(labels.copy(), 4, 6))
    np.testing.assert_array_equal(cluster.relabel(labels),
                                  jax_cluster.relabel(labels))


@pytest.mark.parametrize("n_ids,per_id,size,min_size,max_size", [
    (3, 40, 18, 12, 24),       # big clusters split recursively
    (4, 9, 6, 2, 8),
    (2, 3, 18, 12, 24),        # n // size == 0
])
def test_cluster_trajectories_identical(rng, n_ids, per_id, size, min_size,
                                        max_size):
    centers = rng.normal(size=(n_ids, 16)) * 3
    x = np.concatenate([c + rng.normal(size=(per_id, 16)) * 0.5
                        for c in centers]).astype(np.float32)
    np.testing.assert_array_equal(
        cluster.cluster_trajectories(x, size, min_size, max_size, "cpu"),
        jax_cluster.cluster_trajectories(x, size, min_size, max_size))


@pytest.fixture(scope="module")
def merged_dir(tmp_path_factory):
    """A JAX-extracted, JAX-merged movie dir of the 60-frame clip."""
    root = tmp_path_factory.mktemp("merged")
    clip = jax_make_clip(str(root / f"{MOVIE}-TestFilm-1955.mp4"),
                         n_frames=60, cuts=(30,), seed=3)
    jax_run_extract(clip.path, JaxExtractConfig(
        block_frames=16, max_detections=8, max_tracks=16,
        save_images=False), str(root),
        detector=JaxScriptedDetector(clip, max_detections=8),
        embedders=JaxStubBank())
    d = str(root / f"{MOVIE}-data")
    jax_run_merge(d, MOVIE, JaxMergeConfig(min_face_size=10))
    return d


def test_run_cluster_byte_identical(merged_dir, tmp_path):
    want = shutil.copytree(merged_dir, tmp_path / "jax" / f"{MOVIE}-data")
    got = shutil.copytree(merged_dir, tmp_path / "port" / f"{MOVIE}-data")
    kw = dict(size=2, min_size=1, max_size=4, emb_name="m1")
    jax_cluster.run_cluster(str(want), JaxClusterConfig(**kw))
    labels = cluster.run_cluster(str(got), ClusterConfig(**kw), "cpu")
    a = open(os.path.join(want, "clusters.json"), "rb").read()
    b = open(os.path.join(got, "clusters.json"), "rb").read()
    assert b == a
    assert len(labels) == len(json.loads(a)["clusters"]) >= 2
    report = json.load(open(os.path.join(got, "run_report.json")))
    assert report["cluster"]["env_knobs"]["matmul_allow_tf32"] is False
