"""mfu (%): the model FLOPs of the window's fits (the model module's
`model_flops`) over the window's seconds, as a share of the card's
float32 peak."""


def read(run):
    flops = run.model_flops()
    if flops is None or run.window_s <= 0 or not run.fits:
        return None
    return 100.0 * flops / run.window_s / run.peaks["fp32_flops_per_s"]
