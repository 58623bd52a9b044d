"""One minus the device's busy share of a step: the union of the device's
operations over the traced steps, a step, over the mean step of the same
run's untraced window.  The profiler's host overhead stretches the traced
steps themselves (phi4-mini's 32 blocks under "dots" by about half), so
their own length would count that overhead as idle."""


def read(run):
    if run.trace is None or not run.window.steps:
        return None
    busy = run.trace["busy_s"] / run.trace["steps"]
    return 100 * (1 - busy / (run.window.seconds / run.window.steps))
