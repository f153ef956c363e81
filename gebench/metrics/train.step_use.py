"""train.step_use (%): 100 x the program's `train.blocks` (the corpus'
blocks an epoch, times the epochs run) over its `train.steps` (the steps
run), counted in the window: below 100% where whole chunks of steps wrap
over the blocks and train some a second time."""


def read(run):
    if not run.counters or not run.counters.get("train.steps"):
        return None
    return (100.0 * run.counters.get("train.blocks", 0)
            / run.counters["train.steps"])
