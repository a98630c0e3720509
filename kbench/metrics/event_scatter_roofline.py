"""fused_event_scatter's share of its roofline: valid events a launch
counted as the pods the lanes create in the traced stretch over the
launches (their finishes and node events left out: a lower bound)."""

from kbench.metrics._roofline import launches, share
from kbench.roofline import event_scatter


def read(run):
    found = launches(run, event_scatter.NAMES)
    if found is None:
        return None
    n, seconds = found
    sim = run.sim
    created = run.inputs.arrivals_between(run.before["t"], run.after["t"]) * sim.n_clusters
    need = event_scatter.need(sim.n_clusters, sim.n_nodes, sim.n_pods, sim.max_events_per_window, created // n)
    return share(need, n, seconds)
