# Shared body of the port's launch presets: each <family>.sh sets FAMILY
# and PRESET (its scripts/<family>.sh "with" arguments, letter for
# letter) and sources this file with its own arguments.
#
#   <command>: train | test | visualize | print_config | help
#   <device>:  cuda (default; adds dev.fuse_steps=8, the counterpart of
#              tpu.fuse_steps=8) | cpu (dev.device=cpu) | cpu<N> (N
#              processes on the CPU over gloo under torchrun, with
#              dev.device=cpu dev.mesh=N)
#
# Later k=v arguments win over the preset's (the CLI keeps the last value
# of a key). The entry runs with PYTHONPATH set to the checkout, under
# $PYTHON (default python).

COMMAND=${1:-help}
DEVICE=${2:-cuda}
shift 2 2>/dev/null || shift $#

PROJECT_DIR=$(dirname "$(dirname "$(dirname "$(realpath "$0")")")")
LAUNCH=("${PYTHON:-python}" -m "pemp_tpu_torch.entry.$FAMILY")

case "$DEVICE" in
  cuda) DEV="dev.fuse_steps=8" ;;
  cpu)  DEV="dev.device=cpu" ;;
  cpu[1-9]*)
        N=${DEVICE#cpu}
        DEV="dev.device=cpu dev.mesh=$N"
        LAUNCH=("${PYTHON:-python}" -m torch.distributed.run --standalone
                "--nproc_per_node=$N" -m "pemp_tpu_torch.entry.$FAMILY") ;;
  *)    echo "unknown device '$DEVICE' (cuda | cpu | cpu<N>)" >&2
        exit 2 ;;
esac

if [[ "$COMMAND" == help ]]; then
  ARGS=()
else
  # shellcheck disable=SC2206  # the preset and DEV split on whitespace
  ARGS=(with $PRESET $DEV "$@")
fi

exec env PYTHONPATH="$PROJECT_DIR${PYTHONPATH:+:$PYTHONPATH}" \
  "${LAUNCH[@]}" "$COMMAND" "${ARGS[@]}"
