#!/bin/bash
# Robust04-shape protocol rehearsal (round 4): synthesize a 524k-doc
# MULTI-INDEX Indri repository, then run the full scripts/rank_adhoc.py
# protocol on it end to end — native multi-index ingestion, on-device
# sampled collection-scale training, validation-epoch selection, a
# simulated mid-run crash, and --resume recovery — publishing wall-clock
# and the selected-epoch test MAP to build/rehearse_adhoc.json.
#
# Usage: bash scripts/rehearse_adhoc.sh [root=/tmp/adhoc500k] [workdir]
set -x
ROOT=${1:-/tmp/adhoc500k}
WD=${2:-/tmp/adhoc500k_wd}
cd "$(dirname "$0")/.."

if [ ! -f "$ROOT/fixture.json" ]; then
  python scripts/make_adhoc_fixture.py --root "$ROOT" \
      --num_docs 524288 --num_indexes 4 || exit 1
fi

mkdir -p "$WD"
COMMON=(--corpus "$ROOT/repository" --topics "$ROOT/topics.txt"
        --qrels "$ROOT/qrels.txt" --splits "$ROOT/splits" --workdir "$WD"
        --num_epochs 12 --eval_every 3 --checkpoint_every 3
        --batch_size 51200 --on_device_sampling --steps_per_call 71
        --stream_dtype bfloat16 --window_sum_dtype bfloat16)

# Stage 1: train to epoch 6, then a simulated crash (exercises the
# checkpoint/validation cadence up to the failure point).
python scripts/rank_adhoc.py "${COMMON[@]}" --fail_after_epoch 6
echo "stage 1 exited with $? (expected nonzero: simulated crash)"

# Stage 2: resume from the last dumped epoch and finish the protocol.
python scripts/rank_adhoc.py "${COMMON[@]}" --resume || exit 1

mkdir -p build
cp "$WD/results.json" build/rehearse_adhoc.json
echo REHEARSAL-DONE
