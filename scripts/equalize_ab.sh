#!/usr/bin/env bash
# A/B of the port's equalize kernels on one card, in one machine:
#
#     bash scripts/equalize_ab.sh OLD_ROOT
#
# OLD_ROOT holds an earlier commit's facerec_torch/ (unpack it with
# `git archive <commit> facerec_torch | tar -x -C OLD_ROOT`).  Each side
# runs chip_smoke.py's phase 2 (plane kernels, skewed planes; the RGB
# entry point on this tree only) in its own process, in the order old,
# new, new, old, all timed by this tree's chip_smoke.py.
set -euo pipefail
old=$1
cd "$(dirname "$0")/.."
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for side in old new new old; do
  root=.
  [ "$side" = old ] && root=$old
  echo "=== $side ($root)"
  python3 - "$root" "$side" <<'EOF'
import importlib.util
import os
import sys

root, side = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(root))
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
print("package:", os.path.dirname(smoke.eqm.__file__), flush=True)

import torch

dev = torch.device("cuda")
rate = smoke.mem_rate(torch.cuda.get_device_name(0))
smoke._build.build_all()
smoke.phase_kernels(dev, rate)
smoke.phase_skewed(dev, rate)
if side == "new":
    smoke.phase_rgb(dev, rate)
EOF
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
