"""walk.share (%): the walk spans' share of the window's fits' wall time
(host clock). A walk span is the model's constructor, which walks the
corpus, up to a synchronize; a fit is its walk and its train."""


def read(run):
    fits = run.span_s("walk") + run.span_s("train")
    if not run.fits or fits <= 0:
        return None
    return 100.0 * run.span_s("walk") / fits
