"""Tokens of every step completed in the window, over the window's time (host clock)."""


def read(run):
    return run.window.tokens / run.window.seconds
