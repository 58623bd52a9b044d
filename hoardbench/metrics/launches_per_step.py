"""Device operations a traced step (kernels, copies and fills)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace["launches"] / run.trace["steps"]
