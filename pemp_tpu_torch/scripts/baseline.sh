#!/usr/bin/env bash
# Usage: bash pemp_tpu_torch/scripts/baseline.sh <command> <device> [k=v ...]
#   <command>: train | test | visualize | print_config | help
#   <device>:  cuda (default) | cpu | cpu<N> (N processes over gloo)
# The hyperparameter preset of scripts/baseline.sh, for the PyTorch port
# (launch.sh); explicit k=v overrides still win.

FAMILY=baseline
PRESET="tag=baseline split=0
  tr.total_epochs=6 tr.lr_step=2"

source "$(dirname "$(realpath "$0")")/launch.sh"
