"""train.roofline (%): the trainer layer's bound (`Run.train_bound_s`)
over the device time of the operations launched in train spans."""


def read(run):
    busy = run.busy_in("train")
    bound = run.train_bound_s()
    if not run.traced or busy <= 0 or bound is None:
        return None
    return 100.0 * bound / busy
