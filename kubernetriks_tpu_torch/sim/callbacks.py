"""Run-loop strategies (reference: src/simulation_callbacks.rs)."""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

from kubernetriks_tpu_torch.metrics.printer import print_metrics

if TYPE_CHECKING:
    from kubernetriks_tpu_torch.sim.simulator import KubernetriksSimulation

logger = logging.getLogger("kubernetriks_tpu_torch")


class SimulationCallbacks:
    def on_simulation_start(self, sim: "KubernetriksSimulation") -> None:
        pass

    def on_step(self, sim: "KubernetriksSimulation") -> bool:
        """Runs before each step; returning False stops the run."""
        return True

    def on_simulation_finish(self, sim: "KubernetriksSimulation") -> None:
        pass


def check_all_short_pods_terminated(sim: "KubernetriksSimulation") -> bool:
    metrics = sim.metrics_collector.accumulated_metrics
    return metrics.internal.terminated_pods >= metrics.total_pods_in_trace


def assert_and_print(sim: "KubernetriksSimulation") -> None:
    """Terminal invariant: terminated = succeeded + unschedulable + failed +
    removed (reference: src/simulation_callbacks.rs:44-83)."""
    metrics = sim.metrics_collector.accumulated_metrics
    assert metrics.internal.terminated_pods == (
        metrics.pods_succeeded
        + metrics.pods_unschedulable
        + metrics.pods_failed
        + metrics.pods_removed
    ), (
        f"terminated={metrics.internal.terminated_pods} != succeeded="
        f"{metrics.pods_succeeded} + unschedulable={metrics.pods_unschedulable} "
        f"+ failed={metrics.pods_failed} + removed={metrics.pods_removed}"
    )
    if sim.config.metrics_printer is not None:
        print_metrics(sim.metrics_collector, sim.config.metrics_printer)


class RunUntilAllPodsAreFinishedCallbacks(SimulationCallbacks):
    """Check termination at sim-time multiples of 1000
    (reference: src/simulation_callbacks.rs:85-97)."""

    def on_step(self, sim: "KubernetriksSimulation") -> bool:
        if sim.sim.time() % 1000.0 == 0.0:
            return not check_all_short_pods_terminated(sim)
        return True

    def on_simulation_finish(self, sim: "KubernetriksSimulation") -> None:
        assert_and_print(sim)


class RunUntilAllPodsAreFinishedAndLongRunningPodsExceedDeadlineCallbacks(
    SimulationCallbacks
):
    """Extends the above for long-running services: after all trace pods finish,
    keep stepping until the deadline (reference: src/simulation_callbacks.rs:99-129;
    the reference notes a self-acknowledged instant-termination bug at :114 — the
    deadline branch here is ordered to avoid it)."""

    def __init__(self, deadline_time: float) -> None:
        self.deadline_time = deadline_time
        self.all_short_pods_terminated = False

    def on_step(self, sim: "KubernetriksSimulation") -> bool:
        if self.all_short_pods_terminated:
            return sim.sim.time() < self.deadline_time
        if sim.sim.time() % 1000.0 == 0.0:
            self.all_short_pods_terminated = check_all_short_pods_terminated(sim)
            if self.all_short_pods_terminated:
                return sim.sim.time() < self.deadline_time
        return True

    def on_simulation_finish(self, sim: "KubernetriksSimulation") -> None:
        assert_and_print(sim)
