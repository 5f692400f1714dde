"""Seconds from the process's start to the window's first call: the
extension build or load, the table fill, the generator's encoding and
the warm-up."""


def read(run):
    return run.setup_s
