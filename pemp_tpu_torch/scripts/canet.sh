#!/usr/bin/env bash
# Usage: bash pemp_tpu_torch/scripts/canet.sh <command> <device> [k=v ...]
#   <command>: train | test | visualize | print_config | help
#   <device>:  cuda (default) | cpu | cpu<N> (N processes over gloo)
# The hyperparameter preset of scripts/canet.sh, for the PyTorch port
# (launch.sh); explicit k=v overrides still win.

FAMILY=canet
PRESET="tag=canet split=0
  tr.total_epochs=200 tr.lr=0.0025 data.train_n=10000 data.height=321 data.width=321"

source "$(dirname "$(realpath "$0")")/launch.sh"
