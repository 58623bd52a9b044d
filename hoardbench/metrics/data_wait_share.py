"""The share of the window the host spent in ``next(loader)`` (the stripe
store's reads and the batch's assembly), by the harness's span around it."""


def read(run):
    return 100 * sum(run.window.load_s) / run.window.seconds
