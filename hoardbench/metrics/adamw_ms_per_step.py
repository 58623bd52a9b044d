"""Device ms a traced step under the program's profiler range ``adamw_update``."""


def read(run):
    if run.trace is None or not run.trace["adamw_s"]:
        return None
    return 1e3 * run.trace["adamw_s"] / run.trace["steps"]
