#!/usr/bin/env bash
# Usage: bash pemp_tpu_torch/scripts/rpmms.sh <command> <device> [k=v ...]
#   <command>: train | test | visualize | print_config | help
#   <device>:  cuda (default) | cpu | cpu<N> (N processes over gloo)
# The hyperparameter preset of scripts/rpmms.sh, for the PyTorch port
# (launch.sh); explicit k=v overrides still win.

FAMILY=rpmms
PRESET="tag=rpmms split=0
  tr.total_epochs=200 tr.lr=0.0035 data.height=481 data.width=481"

source "$(dirname "$(realpath "$0")")/launch.sh"
