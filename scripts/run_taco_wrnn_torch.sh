#!/usr/bin/env bash
# Experiment launcher for the PyTorch/CUDA port (the menu of
# scripts/run_taco_wrnn.sh on wavernn_tpu_torch's CLIs): one command per
# stage of the Tacotron + WaveRNN pipeline, on the GPU.
#
# Usage:
#   ./scripts/run_taco_wrnn_torch.sh <experiment> [hp_file] [CLI arguments]
# Experiments: preprocess | taco_tf | taco_gta | taco_attn | taco_af_online |
#              taco_af_offline | wrnn | wrnn_gta | gen | quick_start
#
# The attention-forcing modes come from the hparams file (mode =
# 'attention_forcing_online' / 'attention_forcing_offline'), bfloat16
# Tacotron training from tts_precision = 'bfloat16'. Extra arguments pass
# through to the CLI (--force_cpu runs the kernels' plain versions on the
# CPU). For one process per GPU use scripts/torchrun_train.sh.
set -euo pipefail

EXP=${1:?usage: run_taco_wrnn_torch.sh <experiment> [hp_file] [CLI arguments]}
HP=${2:-}
shift $(( $# < 2 ? $# : 2 ))
HP_ARG=()
[[ -n "$HP" ]] && HP_ARG=(--hp_file "$HP")
PYTHON=${PYTHON:-python}
CLI=wavernn_tpu_torch.cli

case "$EXP" in
  preprocess)      $PYTHON -m $CLI.preprocess "${HP_ARG[@]}" "$@" ;;
  taco_tf)         $PYTHON -m $CLI.train_tacotron "${HP_ARG[@]}" "$@" ;;
  taco_gta)        $PYTHON -m $CLI.train_tacotron --force_gta "${HP_ARG[@]}" "$@" ;;
  taco_attn)       $PYTHON -m $CLI.train_tacotron --force_attn "${HP_ARG[@]}" "$@" ;;
  taco_af_online)  $PYTHON -m $CLI.train_tacotron "${HP_ARG[@]}" "$@" ;;  # mode from hp file
  taco_af_offline) $PYTHON -m $CLI.train_tacotron "${HP_ARG[@]}" "$@" ;;
  wrnn)            $PYTHON -m $CLI.train_wavernn "${HP_ARG[@]}" "$@" ;;
  wrnn_gta)        $PYTHON -m $CLI.train_wavernn --gta "${HP_ARG[@]}" "$@" ;;
  gen)             $PYTHON -m $CLI.gen_tacotron "${HP_ARG[@]}" "$@" wavernn ;;
  quick_start)     $PYTHON -m $CLI.quick_start "${HP_ARG[@]}" "$@" ;;
  *) echo "unknown experiment: $EXP" >&2; exit 1 ;;
esac
