#!/usr/bin/env bash
# Usage: bash pemp_tpu_torch/scripts/pfenet.sh <command> <device> [k=v ...]
#   <command>: train | test | visualize | print_config | help
#   <device>:  cuda (default) | cpu | cpu<N> (N processes over gloo)
# The hyperparameter preset of scripts/pfenet.sh, for the PyTorch port
# (launch.sh); explicit k=v overrides still win.

FAMILY=pfenet
PRESET="tag=pfenet split=0
  tr.total_epochs=90 tr.lr=0.0025 data.height=473 data.width=473"

source "$(dirname "$(realpath "$0")")/launch.sh"
