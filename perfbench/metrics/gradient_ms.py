"""Mean host time of a step's gradient: the benchmark's span around
autograd through the program's model, ending in a synchronize."""


def read(run):
    return run.span_mean_ms("gradient")
