#!/bin/bash
# Multi-host shard launcher (SLURM-compatible) for the PyTorch port.
#
# The port's counterpart of scripts/extract_shards.sh, with the same
# arguments.  Under SLURM, submit with e.g.:
#   sbatch --array=0-3 scripts/extract_shards_torch.sh film.mp4 out 4
# outside SLURM, run one shard:
#   SHARD_I=2 N_SHARDS=4 scripts/extract_shards_torch.sh film.mp4 out 4
# DEVICE picks the device of each shard: cuda (default, the card) or cpu.
#
# Shard outputs rendezvous through filename-encoded frame ranges; run
# `python -m facerec_torch.pipeline.merge --path out/<id>-data` afterwards.
set -euo pipefail

FILM=${1:?usage: extract_shards_torch.sh film.mp4 out_dir n_shards}
OUT=${2:?}
N=${3:?}

SHARD=${SLURM_ARRAY_TASK_ID:-${SHARD_I:?set SHARD_I or run under SLURM}}
COUNT=${SLURM_ARRAY_TASK_COUNT:-${N_SHARDS:-$N}}

REPO="$(cd "$(dirname "$0")/.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

exec python -u -m facerec_torch.pipeline.extract \
  --device "${DEVICE:-cuda}" \
  --n-shards "$COUNT" --shard-i "$SHARD" --save-every 5 \
  --out-path "$OUT" "$FILM"
