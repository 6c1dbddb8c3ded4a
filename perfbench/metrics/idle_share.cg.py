"""Share of the traced window in which no device operation ran: 1 minus the
union of the device events' intervals over the window."""


def read(run):
    return run.trace.idle_percent() if run.trace is not None else None
