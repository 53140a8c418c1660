"""Pipeline configuration.

One frozen dataclass per stage, defaults chosen to match the reference
CLI defaults (cf. reference facerec/extract.py:374-387,
merge_shards.py:279-290, cluster.py:229-238, classify_knn.py:285-287)
so that a reference user can switch over without changing behaviour.

The block size and the fixed capacities of the device path live here
too.  This is the port's own copy of ``facerec_tpu/config.py`` (same
classes, same defaults), so ``facerec_torch`` never imports the JAX
package; a few fields exist only so that a config carries over from
the JAX package, and the port does not read them (said below).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# The four FaceNet checkpoints the reference loads
# (reference facerec/extract.py:24-25).  The first two embed to 512
# dims, the last two to 128 dims; downstream stages use only EMB_NAME.
FACENET_MODELS: Tuple[str, ...] = (
    "20180402-114759",
    "20180408-102900",
    "20170511-185253",
    "20170512-110547",
)
FACENET_DIMS = {
    "20180402-114759": 512,
    "20180408-102900": 512,
    "20170511-185253": 128,
    "20170512-110547": 128,
}
# Embedding used by cluster/classify stages (cluster.py:17, classify_knn.py:13)
EMB_NAME = "20170512-110547"

FACE_IMAGE_SIZE = 160          # face crops resolution (extract.py:27)
SAVE_FACE_PADDING = 0.10       # padding for saved crops (extract.py:28)
CROP_MARGIN = int(0.1 * 160)   # cropBox margin in px (extract.py:163)

ACTOR_ID_PREFIX = "momaf:elonet_henkilo_"  # classify_knn.py:15


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Config of the extract stage (decode→scene→detect→track→embed)."""

    # Reference-visible knobs (extract.py:376-387)
    n_shards: int = 1                 # single chip replaces 100-256 CPU shards
    shard_i: int = 0
    save_every: int = 5
    iou_threshold: float = 0.5
    min_trajectory: int = 3
    max_trajectory_age: int = 5
    min_face_size: int = 20
    face_threshold: float = 0.95
    save_images: bool = True
    display_width: Optional[int] = None
    display_height: Optional[int] = None

    # Device path: frames per block (one upload, one scene/detector/
    # tracker pass and one pull of results per block) and fixed
    # capacities of the detector output and the track table
    block_frames: int = 128
    max_detections: int = 16          # per-frame detection capacity
    max_tracks: int = 32              # live track table capacity
    # Detector input (H, W); None = fit to the film's aspect ratio
    # (stride-32 multiples) so no FLOPs run on padding.
    detector_size: Optional[Tuple[int, int]] = None
    # Long side of the AR-fitted detector input.  None (default) =
    # native display resolution — parity-first, like the reference
    # which detects at display scale
    # (reference facerec/detector.py:20, min_face_size=20).
    # Setting 512 downscales a 576x768 film 1.5x, which loses the
    # smallest faces for less detector work: an opt-in, not the default.
    detector_long_side: Optional[int] = None
    # Detector backbone width for random-init harnesses (a checkpoint
    # carries its own width, read back from its stem kernel).  96 is the
    # width of the committed probe detector.
    backbone_width: int = 96
    # Not read by the port: it computes in float32 throughout.
    compute_dtype: str = "bfloat16"

    # Parallel native decode workers (0 = FACEREC_DECODE_WORKERS, else
    # sequential); checked against sequential decode once per film.
    decode_workers: int = 0

    # Device→host fetches of N consecutive blocks grouped into one
    # transfer (output bytes are the same at any N).
    fetch_every_blocks: int = 4

    # Host→device pixel wire format.  "rgb": the decoded frames upload
    # as they are; "rgb-delta": uint8 temporal deltas, undone exactly on
    # the device (the same output bytes); "yuv420-delta": 4:2:0 planes
    # and deltas (half the bytes; a few LSB of chroma lost).
    wire_format: str = "rgb"

    # Fault tolerance (SURVEY.md §5.3-5.4): block-granular in-stage
    # checkpoints + idempotent shard completion markers
    checkpoint_every_blocks: int = 0  # 0 = no in-stage checkpoints
    resume: bool = True               # skip done shards, resume checkpoints


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    """Config of the shard/block merge stage (merge_shards.py:279-290)."""

    iou_threshold: float = 0.5
    overlap: int = 5                  # must match max_trajectory_age
    min_face_size: int = 50
    # Reproduce merge_shards.py:237-240 exactly: cross-shard merges
    # require strict t2.start < t1.start and are skipped entirely when
    # t1 starts at a scene cut — which keeps duplicate tracks that
    # spawned inside the overlap halo in both shards.  Default (False)
    # also dedups equal-start pairs, keeping sharded == unsharded.
    strict_start: bool = False


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Config of the trajectory clustering stage (cluster.py:229-238)."""

    size: int = 18
    min_size: int = 12
    max_size: int = 24
    emb_name: str = EMB_NAME


@dataclasses.dataclass(frozen=True)
class ClassifyConfig:
    """Config of the KNN actor classification stage (classify_knn.py:285-293)."""

    k: int = 10
    min_samples: int = 20
    save_p_higher: float = 0.05
    emb_name: str = EMB_NAME


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    extract: ExtractConfig = dataclasses.field(default_factory=ExtractConfig)
    merge: MergeConfig = dataclasses.field(default_factory=MergeConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    classify: ClassifyConfig = dataclasses.field(default_factory=ClassifyConfig)
