"""Mean streams a decode tick serves: the frames the engine generated in
the window over its decode ticks (the engine's counter)."""


def read(run):
    ticks = run.record["counters"].get("decode_ticks")
    return run.record["gen_items"] / ticks if ticks else None
