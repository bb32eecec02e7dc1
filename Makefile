# Tier-1 verify + benchmark entry points.
PY ?= python
export PYTHONPATH := src:$(PYTHONPATH)

.PHONY: test ci chaos deprecations lint-repro verify-plans api-demo \
        trace-demo calibrate bench-kernels bench-dispatch bench

test:
	$(PY) -m pytest -x -q

# Fault-injection (chaos) suite only: guarded execution ladder, poisoned-
# slot quarantine, deadline retirement (tests marked @pytest.mark.chaos).
# Included in `make test` too — this target is the fast failure-semantics
# gate CI runs by name.
chaos:
	$(PY) -m pytest -x -q -m chaos

# Deprecation gate: the FULL tier-1 suite, erroring on any
# DeprecationWarning ATTRIBUTED TO a repro.* module — i.e. repro-internal
# code still calling the deprecated run_layer/run_stack shims (tests may
# call them — the warning is attributed to the caller; internal code must
# go through repro.rnn).  The module field is a pytest regex.  A strict
# superset of `make test`, so CI runs the suite exactly once, under it.
deprecations:
	$(PY) -m pytest -x -q -W "error::DeprecationWarning:repro\."

# Static repo lint (repro.analysis.repolint): no deprecated-shim calls, no
# bare assert/RuntimeError on the serving path, one fenced clock
# (runtime/obs.py), no Slot-internals coupling outside planner/executor/
# analysis.  Pure AST walk — no test execution, fails CI before pytest.
# The second line lints the PyTorch port (repro_torch.analysis.repolint).
lint-repro:
	$(PY) -m repro.analysis.repolint src/repro
	$(PY) -m repro_torch.analysis.repolint src/repro_torch

# The static-analysis suite by name: the plan-invariant mutation tests
# (every seeded corruption rejected with its rule, pristine plans clean)
# plus the lint's own tests.  A subset of `make test`; CI runs it early
# as the fast dispatch-invariant gate.
verify-plans:
	$(PY) -m pytest -x -q tests/analysis

# The unified front-end tour (compile/forward/prefill/decode + plans).
api-demo:
	$(PY) examples/rnn_api_demo.py

# Traced forward + decode -> artifacts/trace.json (chrome://tracing),
# metrics_snapshot.json, launch_costs.json (predicted vs measured).
# CI runs this and uploads the trace as a build artifact.
trace-demo:
	$(PY) examples/trace_demo.py --out-dir artifacts

# Compile-and-replay calibration (repro.calib): replay the smoke grid of
# launch shapes through the shared obs clock into
# artifacts/measured_costs.json (merged across runs, backend-tagged), then
# re-replay every signature and exit nonzero if any fresh measurement
# disagrees with the stored median beyond 25x — the unit/lowering sanity
# gate (generous: it catches a broken replay, not scheduler jitter).  CI
# runs this and uploads the table as a build artifact; plan against it
# with ExecutionPolicy(cost_model="measured").
calibrate:
	$(PY) -m repro.calib --grid smoke --repeats 3 --check 25

# What CI runs (.github/workflows/ci.yml): the static lint first (no test
# execution needed), then the tier-1 suite (which already includes the
# benchmark smoke tests — tests/test_bench_smoke.py runs the kernels +
# dispatch suites end-to-end and checks their claims) under the
# deprecations gate — one pytest run covers both.
ci: lint-repro deprecations

# Kernel microbench suite; writes BENCH_kernels.json (committed — the
# cross-PR perf trajectory).
bench-kernels:
	$(PY) benchmarks/run.py --suite kernels

# Tile-dispatcher suite; writes BENCH_dispatch.json (committed — packed
# vs per-request launch counts + oracle latency).
bench-dispatch:
	$(PY) benchmarks/run.py --suite dispatch

bench:
	$(PY) benchmarks/run.py
