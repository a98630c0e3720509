"""fused_select_cycle_commit's share of its roofline: picks a launch
counted as the decisions of the traced stretch over the launches, spread
evenly over the lanes, and the queue as deep as the picks (attempts that
park and deeper queues left out: a lower bound)."""

from kbench.metrics._roofline import decisions_per_launch, launches, share
from kbench.roofline import select_cycle_commit


def read(run):
    found = launches(run, select_cycle_commit.NAMES)
    if found is None:
        return None
    n, seconds = found
    sim = run.sim
    C = sim.n_clusters
    picks = [decisions_per_launch(run, n) / C] * C
    return share(select_cycle_commit.need(C, sim.n_nodes, sim.n_pods, picks, picks), n, seconds)
