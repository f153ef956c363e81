"""device.idle_share (%): the share of the traced window in which no
device operation ran."""


def read(run):
    if not run.traced or run.busy_s is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
