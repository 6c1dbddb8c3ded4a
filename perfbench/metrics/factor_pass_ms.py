"""Mean host time of the factor pass: the benchmark's span around
``KFACLinearOperator(...)``, ending in a synchronize, over the window's
steps."""


def read(run):
    return run.span_mean_ms("factor_pass")
