"""fused_schedule_cycle's share of its roofline (the sorted route): live
candidate rows a launch counted as the decisions of the traced stretch
over the launches (rows that park left out: a lower bound)."""

from kbench.metrics._roofline import decisions_per_launch, launches, share
from kbench.roofline import schedule_cycle


def read(run):
    found = launches(run, schedule_cycle.NAMES)
    if found is None:
        return None
    n, seconds = found
    sim = run.sim
    live = int(decisions_per_launch(run, n))
    return share(schedule_cycle.need(sim.n_clusters, sim.n_nodes, sim.max_pods_per_cycle, live), n, seconds)
