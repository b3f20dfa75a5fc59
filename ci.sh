#!/usr/bin/env bash
# CI entry point (SURVEY.md §2.3 — the reference's GitLab CI builds both
# artifacts and runs the Python suite; this is the equivalent one-command
# gate). Run before every round snapshot: a red suite must never ship.
#
#   ./ci.sh          build native artifacts + full test suite
#   ./ci.sh --bench  also run the quick benchmark smoke (needs a GPU)
set -euo pipefail
cd "$(dirname "$0")"

echo "== build: C++ oracle (golden-parity authority) =="
make -C oracle

echo "== build: native IO runtime =="
make -C native

echo "== tests: full suite (CPU via tests/conftest.py) =="
python -m pytest tests/ -q

echo "== tests: on-card lane (every test skips, with its reason, without a GPU) =="
# Per-filter GPU-vs-CPU parity at A4, compile-time memory budgets at the
# bench shape (A4 x 16), the Triton ACE kernel compiled for the card, and
# the fused chain at the bench shape. On a GPU machine, chip_smoke.py runs
# this lane as its last phase, after the end-to-end phases.
python -m pytest tests_gpu/ -q -rs

if [[ "${1:-}" == "--bench" ]]; then
  echo "== bench: quick smoke =="
  python bench.py --quick
fi

echo "CI OK"
