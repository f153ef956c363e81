"""train.prepare_ms (ms): device ms a fit of the operations whose
innermost program span is `train.prepare` (each epoch's `prepare_epoch`)
or `train.draws` (a chunk's window draws, negative ids, token blocks and
learning rates)."""


def read(run):
    busy = run.program_busy_s("train.prepare", "train.draws")
    return None if busy is None else busy * 1e3 / run.fits
