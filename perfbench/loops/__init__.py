"""One module per kind of traffic: set-up, one unit of work, end-to-end
metrics and the outputs the check compares."""
