"""train.step_roofline (%): `train.roofline`'s bound (`Run.train_bound_s`)
over the device time of the operations whose innermost program span is
`chunk.replay`: the trainer's steps alone, without its tables, epoch
preparation and copies."""


def read(run):
    replay = run.program_busy_s("chunk.replay")
    bound = run.train_bound_s()
    if not replay or bound is None:
        return None
    return 100.0 * bound / replay
