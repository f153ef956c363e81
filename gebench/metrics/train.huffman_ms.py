"""train.huffman_ms (ms): wall ms a fit of the program's
`train.tables.huffman` spans (`build_huffman`, hs=1 only; the host's
clock)."""


def read(run):
    return run.program_ms("train.tables.huffman")
