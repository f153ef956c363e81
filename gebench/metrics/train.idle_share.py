"""train.idle_share (%): the share of the train spans' wall time in which
no device operation launched in them ran: the trainer's host work (per-fit
tables, the Huffman build, epoch preparation, copies) that the card waits
on."""


def read(run):
    span = run.span_s("train")
    if not run.traced or span <= 0:
        return None
    return 100.0 * (1.0 - run.busy_in("train") / span)
