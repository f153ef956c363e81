"""train.tables_ms (ms): wall ms a fit of the program's `train.tables`
spans (counts, negative table or Huffman tree, keep probabilities, table
init; the host's clock)."""


def read(run):
    return run.program_ms("train.tables")
