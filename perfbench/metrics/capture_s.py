"""Host time of the first solve in set-up: the warm-up, the capture of the
solver's chunked loop and its first replays, ending in a synchronize."""


def read(run):
    spans = run.spans.get("first_solve")
    return spans[0] if spans else None
