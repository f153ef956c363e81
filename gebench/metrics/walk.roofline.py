"""walk.roofline (%): the walk layer's bound over the device time of the
operations launched in walk spans. The bound is the CSR read once and the
corpus written once (`work.walk_bytes`) at the card's HBM peak, for each
fit of the window."""

from gebench import work


def read(run):
    busy = run.busy_in("walk")
    if not run.traced or busy <= 0:
        return None
    bound = (work.walk_bytes(run.cell.config, run.V, run.E) * run.fits
             / run.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / busy
