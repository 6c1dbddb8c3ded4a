"""Mean host time of a refresh's damped inverse: the benchmark's span
around ``inverse(...)``, ending in a synchronize, over the refresh steps."""


def read(run):
    return run.span_mean_ms("inverse")
