"""chunk.copy_ms (ms): device ms a fit of the operations whose innermost
program span is `chunk.copy_in` or `chunk.copy_out` (a chunk graph's
tables and inputs copied in, its tables and outputs out)."""


def read(run):
    busy = run.program_busy_s("chunk.copy_in", "chunk.copy_out")
    return None if busy is None else busy * 1e3 / run.fits
