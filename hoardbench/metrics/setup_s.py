"""Seconds from the process's start to the first timed step's start."""


def read(run):
    return run.setup_s
