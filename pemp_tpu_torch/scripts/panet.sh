#!/usr/bin/env bash
# Usage: bash pemp_tpu_torch/scripts/panet.sh <command> <device> [k=v ...]
#   <command>: train | test | visualize | print_config | help
#   <device>:  cuda (default) | cpu | cpu<N> (N processes over gloo)
# The hyperparameter preset of scripts/panet.sh, for the PyTorch port
# (launch.sh); explicit k=v overrides still win.

FAMILY=panet
PRESET="tag=panet split=0
  tr.total_epochs=3 tr.lr_step=1 tr.lr=0.001 data.train_n=10000 data.bs=1"

source "$(dirname "$(realpath "$0")")/launch.sh"
