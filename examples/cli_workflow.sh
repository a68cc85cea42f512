#!/usr/bin/env bash
# The reference's end-to-end folder workflow on synthetic data:
# partitioned inputs -> GPLVM fit -> embeddings + checkpoint -> resume.
set -euo pipefail
cd "$(dirname "$0")/.."
WORK=$(mktemp -d)
python - <<PY
from gparml import data
y, _ = data.synthetic_gplvm(n=500, d=8, q_true=2, seed=0)
data.save_partitioned("$WORK/inputs", y, 4, prefix="Y")
print("wrote 4 partitions to $WORK/inputs")
PY
python -m gparml.cli -i "$WORK/inputs" -e "$WORK/embeddings" -s "$WORK/stats" \
    -T 50 -q 3 -m 20
echo "--- resuming ---"
python -m gparml.cli -i "$WORK/inputs" -e "$WORK/embeddings" -s "$WORK/stats" \
    -T 20 -q 3 -m 20 --load
echo "artifacts in $WORK"
