#!/usr/bin/env bash
# Usage: bash pemp_tpu_torch/scripts/pemp_stage2.sh <command> <device> [k=v ...]
#   <command>: train | test | visualize | print_config | help
#   <device>:  cuda (default) | cpu | cpu<N> (N processes over gloo)
# The hyperparameter preset of scripts/pemp_stage2.sh, for the PyTorch port
# (launch.sh); explicit k=v overrides still win.

FAMILY=pemp_stage2
PRESET="tag=pemp_stage2 split=0
  loss=cedt tr.total_epochs=200 tr.lr=0.0035 net.backbone=resnet50 net.backbone2=resnet50 net.cm=True"

source "$(dirname "$(realpath "$0")")/launch.sh"
