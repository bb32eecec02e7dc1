"""Share of the measured window's wall (a traced run's unprofiled one)
that the engine spent in its ``lm.remainder`` spans: the batch-1 decode
steps that carry a bucketed prefill past its power-of-two bucket.  The
driver diffs the engine tracer's totals around the window; None where the
engine was not traced."""


def read(run):
    spans = run.record.get("spans_s")
    if not spans:
        return None
    return 100.0 * spans.get("lm.remainder", 0.0) / run.record["window_s"]
