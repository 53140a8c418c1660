#!/bin/bash
# End-to-end pipeline launcher for one film on one host, PyTorch port.
#
# The port's counterpart of scripts/run_pipeline.sh, with the same
# arguments.  DEVICE picks the device: cuda (default, the card) or cpu.
# MESH=N runs extract as N spans at once, one process per card (with
# DEVICE=cpu, N CPU processes); its shard files merge as N shards do.
#
# Usage: scripts/run_pipeline_torch.sh <film.mp4> <out_dir> [actors_dir]
set -euo pipefail

FILM=${1:?usage: run_pipeline_torch.sh film.mp4 out_dir [actors_dir]}
OUT=${2:?usage: run_pipeline_torch.sh film.mp4 out_dir [actors_dir]}
ACTORS=${3:-}

REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

# build native helpers if missing
if [ ! -f "$REPO/native/libfacerec_decode.so" ]; then
  make -C "$REPO/native"
fi

ARGS=(--device "${DEVICE:-cuda}" --mesh "${MESH:-0}" --filmfile "$FILM"
      --out-path "$OUT")
if [ -n "$ACTORS" ]; then
  ARGS+=(--actors-dir "$ACTORS")
fi
exec python -u -m facerec_torch.pipeline.orchestrate "${ARGS[@]}"
