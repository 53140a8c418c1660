"""The port's merge stage against the JAX package's (host code, CPU).

The JAX extract writes the shard files of the 60-frame synthetic clip
(scripted detections, the stub embedder) with 1 and 2 shards; each
package's ``run_merge`` then runs on its own copy of that directory.
The merged files must be byte-identical and the ``merge`` counters
equal, with ``strict_start`` off and on.
"""
import copy
import json
import os
import shutil

import pytest

from facerec_tpu.config import ExtractConfig as JaxExtractConfig
from facerec_tpu.config import MergeConfig as JaxMergeConfig
from facerec_tpu.contract import records as jax_records
from facerec_tpu.pipeline import merge as jax_merge
from facerec_tpu.pipeline.extract import run_extract as jax_run_extract
from facerec_tpu.video.synth import ScriptedDetector as JaxScriptedDetector
from facerec_tpu.video.synth import make_clip as jax_make_clip
from tests.test_extract_e2e import StubEmbedderBank as JaxStubBank

from facerec_torch.config import MergeConfig
from facerec_torch.pipeline import merge

MOVIE = 125261
MERGED = ("trajectories.jsonl", "features.jsonl", "scene_changes.json")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clips") / f"{MOVIE}-TestFilm-1955.mp4")
    return jax_make_clip(path, n_frames=60, cuts=(30,), seed=3)


@pytest.fixture(scope="module")
def shard_dirs(clip, tmp_path_factory):
    """n_shards → the JAX extract's movie dir (shard files + images)."""
    out = {}
    for n_shards in (1, 2):
        root = str(tmp_path_factory.mktemp(f"extract{n_shards}"))
        for i in range(n_shards):
            jax_run_extract(
                clip.path, JaxExtractConfig(
                    n_shards=n_shards, shard_i=i, block_frames=16,
                    max_detections=8, max_tracks=16),
                root, detector=JaxScriptedDetector(clip, max_detections=8),
                embedders=JaxStubBank())
        out[n_shards] = os.path.join(root, f"{MOVIE}-data")
    return out


def copy_dir(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def merged_bytes(data_dir):
    return {n: open(os.path.join(data_dir, n), "rb").read() for n in MERGED}


def merge_counters(data_dir):
    with open(os.path.join(data_dir, "run_report.json")) as f:
        return json.load(f)["merge"]["counters"]


@pytest.mark.parametrize("strict_start", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_run_merge_byte_identical(shard_dirs, tmp_path, n_shards,
                                  strict_start):
    want = copy_dir(shard_dirs[n_shards], tmp_path / "jax" / f"{MOVIE}-data")
    got = copy_dir(shard_dirs[n_shards], tmp_path / "port" / f"{MOVIE}-data")
    kw = dict(min_face_size=20, strict_start=strict_start)
    want_c = jax_merge.run_merge(want, MOVIE, JaxMergeConfig(**kw))
    got_c = merge.run_merge(got, MOVIE, MergeConfig(**kw))
    assert got_c == want_c
    assert want_c["saved"] >= 2
    assert merged_bytes(got) == merged_bytes(want)
    assert merge_counters(got) == merge_counters(want)


def test_cli_matches_run_merge(shard_dirs, tmp_path):
    """``main`` over a glob of movie dirs writes what ``run_merge``
    writes."""
    cli = copy_dir(shard_dirs[2], tmp_path / "cli" / f"{MOVIE}-data")
    direct = copy_dir(shard_dirs[2], tmp_path / "direct" / f"{MOVIE}-data")
    merge.main(["--path", str(tmp_path / "cli" / "*-data"),
                "--min-face-size", "20"])
    merge.run_merge(direct, MOVIE, MergeConfig(min_face_size=20))
    assert merged_bytes(cli) == merged_bytes(direct)


def traj(start, bbs):
    return jax_records.trajectory_record(start, bbs, [True] * len(bbs),
                                         320, 240)


# (function name, arguments) cases of tests/test_merge.py plus a few
# more: adjacency with high IoU, a seam at a scene cut, no overlap, a
# chain of three, two candidates of different IoU, and the filters
STITCH_CASES = {
    "adjacent": ([traj(2, [[13, 10, 53, 50], [14, 10, 54, 50]]),
                  traj(0, [[10, 10, 50, 50], [12, 10, 52, 50]])], set()),
    "scene_cut": ([traj(0, [[10, 10, 50, 50], [12, 10, 52, 50]]),
                   traj(2, [[13, 10, 53, 50]])], {2}),
    "no_overlap": ([traj(0, [[10, 10, 50, 50]]),
                    traj(1, [[200, 200, 240, 240]])], set()),
    "chain": ([traj(0, [[10, 10, 50, 50]]), traj(1, [[11, 10, 51, 50]]),
               traj(2, [[12, 10, 52, 50]])], set()),
    "best_of_two": ([traj(0, [[10, 10, 50, 50]]),
                     traj(1, [[20, 10, 60, 50]]),
                     traj(1, [[11, 10, 51, 50]])], set()),
}
FILTER_CASES = [
    ("big_enough", (traj(5, [[0, 0, 10, 10], [0, 0, 60, 60]]), 50)),
    ("big_enough", (traj(0, [[0, 0, 30, 30]]), 50)),
    ("has_image", (traj(5, [[0, 0, 10, 10], [0, 0, 60, 60]]),
                   {5: {(0, 0, 10, 10)}})),
    ("has_image", (traj(9, [[0, 0, 10, 10]]), {5: {(0, 0, 10, 10)}})),
]


@pytest.mark.parametrize(
    "fn,args",
    [("stitch_within_shard", (trajs, cuts, 0.5))
     for trajs, cuts in STITCH_CASES.values()] + FILTER_CASES,
    ids=[f"stitch_{k}" for k in STITCH_CASES]
    + [f"{n}{i}" for i, (n, _) in enumerate(FILTER_CASES)])
def test_helpers_match_jax(fn, args):
    want = getattr(jax_merge, fn)(*copy.deepcopy(args))
    got = getattr(merge, fn)(*copy.deepcopy(args))
    assert got == want
