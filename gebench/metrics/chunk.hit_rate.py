"""chunk.hit_rate (%): 100 x the chunk-graph cache's hits over its hits
and captures (`chunk.hits`, `chunk.captures`) counted in the window."""


def read(run):
    if not run.counters:
        return None
    hits = run.counters.get("chunk.hits", 0)
    looked = hits + run.counters.get("chunk.captures", 0)
    return 100.0 * hits / looked if looked else None
