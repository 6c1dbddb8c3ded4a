"""Mean host time of applying the held inverse to the gradient: the
benchmark's span, ending in a synchronize, over the window's steps."""


def read(run):
    return run.span_mean_ms("apply")
