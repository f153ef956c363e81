"""walk.roofline (%): the walk layer's bound over the device time of the
operations launched in walk spans. The bound is the bytes the walk must
move (the model module's `walk_bytes`: the CSR read once and the corpus
written once) at the card's HBM peak, for each fit of the window."""


def read(run):
    busy = run.busy_in("walk")
    nbytes = run.walk_bytes()
    if not run.traced or busy <= 0 or nbytes is None:
        return None
    return 100.0 * nbytes / run.peaks["hbm_bytes_per_s"] / busy
