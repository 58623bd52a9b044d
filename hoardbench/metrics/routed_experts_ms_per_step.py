"""Device ms a traced step of the routed experts' batched products and their
gradients (``frozen.groups.is_routed_expert_bmm``)."""


def read(run):
    if run.trace is None or not run.trace["routed_experts_s"]:
        return None
    return 1e3 * run.trace["routed_experts_s"] / run.trace["steps"]
