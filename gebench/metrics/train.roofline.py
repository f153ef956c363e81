"""train.roofline (%): the trainer layer's bound over the device time of
the operations launched in train spans. The bound is the larger of the
model FLOPs (`work.flops_per_pair` of the nominal pairs) at the card's
float32 peak and both tables read and written once an epoch
(`work.train_bytes`) at its HBM peak, for each fit of the window."""

from gebench import work


def read(run):
    busy = run.busy_in("train")
    flops = run.model_flops()
    if not run.traced or busy <= 0 or flops is None:
        return None
    bound = max(flops / run.peaks["fp32_flops_per_s"],
                work.train_bytes(run.cell.config, run.V) * run.fits
                / run.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / busy
