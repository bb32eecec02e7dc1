"""Mean wall of an admission wave in a traced run's unprofiled window:
the benchmark's span around the engine's ``compiled.prefill``,
synchronised at its end (the engine reads the outputs back at once)."""


def read(run):
    walls = [c[1] for c in run.record["calls"] if c[0] == "prefill"]
    return 1e3 * sum(walls) / len(walls) if walls else None
