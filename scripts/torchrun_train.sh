#!/usr/bin/env bash
# Data-parallel training with the PyTorch/CUDA port on every GPU of this
# machine: one process per card under torchrun, NCCL between them. Each
# rank trains on its slice of every global batch (the batch size must
# divide by the card count); rank 0 writes the checkpoints and logs.
#
#   ./scripts/torchrun_train.sh wavernn  --hp_file hparams.py [--batch_size 64]
#   ./scripts/torchrun_train.sh tacotron --hp_file hparams.py
#
# NPROC overrides the process count (default: the cards nvidia-smi lists).
set -euo pipefail

MODEL=${1:?usage: torchrun_train.sh wavernn|tacotron [CLI arguments]}
shift
case "$MODEL" in
  wavernn|tacotron) ;;
  *) echo "torchrun_train.sh: the model is wavernn or tacotron, not $MODEL" >&2
     exit 2 ;;
esac
NPROC=${NPROC:-$(nvidia-smi -L | wc -l)}

exec torchrun --standalone --nproc_per_node="$NPROC" \
  -m "wavernn_tpu_torch.cli.train_$MODEL" "$@"
