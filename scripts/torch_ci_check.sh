#!/usr/bin/env bash
# The PyTorch port's CI gate: ytpu-lint over the port, the port's
# metrics-schema and trace-validity checks, the marker smokes over the
# port's suites, the planner oracle corpus under each per-doc backend,
# and the port's whole fast tier, in the order of the JAX package's gate.
#
#     scripts/torch_ci_check.sh [--device cpu|cuda]
#
# --device cuda (the default) runs the two checks on the CUDA device and
# adds the card-only tests (tests/test_torch_cuda.py -m cuda); --device
# cpu runs the checks on the kernels' plain PyTorch versions.  The test
# suites hold the port against the JAX package on the CPU, so their steps
# need a host where both import.  Extra pytest options (for example
# "-p xdist -n 4 --dist loadfile") pass through PYTEST_ADDOPTS.
set -euo pipefail
cd "$(dirname "$0")/.."

device=cuda
while [[ $# -gt 0 ]]; do
    case "$1" in
        --device) device="${2:?--device needs cpu or cuda}"; shift 2 ;;
        --device=*) device="${1#--device=}"; shift ;;
        *) echo "usage: $0 [--device cpu|cuda]" >&2; exit 2 ;;
    esac
done
case "$device" in
    cpu) check_args=(--device cpu) ;;
    cuda) check_args=() ;;
    *) echo "--device must be cpu or cuda, not '$device'" >&2; exit 2 ;;
esac

PORT_TESTS=(tests/test_torch_*.py)

smoke() {
    # one marker's cases among the port's suites
    echo "== $1 smoke (marker: $1) =="
    python -m pytest "${PORT_TESTS[@]}" -q -m "$1 and not slow" \
        -p no:cacheprovider
}

echo "== static analysis (ytpu-lint over the port) =="
python scripts/torch_ytpu_lint.py --ci

echo "== metrics schema (device: $device) =="
python scripts/torch_check_metrics_schema.py ${check_args[@]+"${check_args[@]}"}

echo "== trace validity (torch_check_trace selftest, device: $device) =="
# a 3-shard replicated port fleet with everything sampled, rooms on the
# engine: all flow arrows resolve, every sampled chain reaches visibility
python scripts/torch_check_trace.py --selftest ${check_args[@]+"${check_args[@]}"}

for marker in tsdb cost geo admin cluster analysis flushpipe tracing \
        admission loadgen planner; do
    smoke "$marker"
done

echo "== planner oracle corpus under the np and jax per-doc backends =="
# the port's cold planner defaults to the chunked "device" lane; rerun
# the oracle corpus with each per-doc lane pinned ("jax" names the
# per-doc kernel mode, as in the JAX package)
YTPU_PLAN_SEGMENT=np python -m pytest tests/test_torch_segment_planner.py \
    -q -m 'not slow' -p no:cacheprovider
YTPU_PLAN_SEGMENT=jax python -m pytest tests/test_torch_segment_planner.py \
    -q -m 'not slow' -p no:cacheprovider

for marker in failover tiering fleet; do
    smoke "$marker"
done

if [[ "$device" == "cuda" ]]; then
    echo "== kernels on the card (marker: cuda) =="
    python -m pytest tests/test_torch_cuda.py -q -m cuda -p no:cacheprovider
fi

echo "== the port's tier (not slow) =="
python -m pytest "${PORT_TESTS[@]}" -q -m 'not slow' -p no:cacheprovider
