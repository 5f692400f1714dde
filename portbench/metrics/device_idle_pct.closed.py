"""Share of the window in which no operation ran on the device: the
complement of the union of the device intervals of the trace."""
from portbench.lib.readers import idle_pct


def read(run):
    return idle_pct(run)
