"""The check that decides `correct` fails a run whose timed path is
broken underneath, and fails the control. A whole run of a cell at a
size the CPU holds (the harness's look for a card skipped), with a fault
planted in the program's engine:

- a step that returns its state unchanged;
- half of the batch left out (the upper half of the lanes never steps);
- an answer altered where it is produced (a bound pod moved to another
  node after every span).

The cells run on one card, so there is no exchange between chips to
leave out. The control (the reference in bfloat16 in the program's
place) is held failing in test_control_fails."""

import argparse
import copy
import time

import pytest
import torch

from kbench import run as harness
from kbench.reference import control

CELLS = ("alibaba-v2017.sweep1024", "kubernetriks-config-yaml.ca-sweep1024", "alibaba-v2017.single")


def small_spec(cell):
    spec = copy.deepcopy(harness.find(harness.load_manifest(), cell))
    config, traffic = spec["config"], spec["traffic"]
    if config["generator"] == "alibaba_v2017":
        config["cluster"]["machines"] = 48
        config["workload"]["tasks_per_day"] = 4000
    else:
        config["workload"]["rate_per_s"] = 0.2
    traffic.update(lanes=min(4, traffic["lanes"]), warm_until=600.0, check_lanes=min(2, traffic["lanes"]),
                   trace_days=0.5)
    traffic["engine"] = {"pod_window": 256}
    return spec


def run_small(monkeypatch, cell, plant=None):
    from kubernetriks_tpu_torch.batched import engine

    if plant is not None:
        real = engine.BatchedSimulation.step_until_time
        monkeypatch.setattr(engine.BatchedSimulation, "step_until_time", lambda sim, t: plant(sim, t, real))
    args = argparse.Namespace(workload=cell, seed=2**31 + 99, seconds=2.0, trace=0)
    return harness.execute(small_spec(cell), args, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(monkeypatch, cell):
    result = run_small(monkeypatch, cell)
    assert result["correct"] and result["attempted"] > 0
    assert list(result["checks"]) == ["pods_differing", "counters_differing"]


def unchanged(sim, t, real):
    time.sleep(0.005)  # as long as a short step takes, so the window ends inside the trace


def half_left_out(sim, t, real):
    from kubernetriks_tpu_torch.batched.state import flatten

    C = sim.n_clusters
    before = {k: v.clone() for k, v in flatten(sim.state).items()}
    real(sim, t)
    for key, leaf in flatten(sim.state).items():
        if leaf.dim() and leaf.shape[0] == C and key in before and before[key].shape == leaf.shape:
            leaf[C // 2:] = before[key][C // 2:]


def answer_altered(sim, t, real):
    real(sim, t)
    pods, nodes = sim.state.pods, sim.state.nodes
    running = pods.phase == 3
    for c in range(sim.n_clusters):
        slots = torch.nonzero(running[c]).flatten()
        if slots.numel():
            s = int(slots[-1])
            pods.node[c, s] = (pods.node[c, s] + 1) % nodes.alive.shape[1]


FAULTS = [(cell, plant) for cell in CELLS for plant in (unchanged, half_left_out, answer_altered)
          if not (plant is half_left_out and cell.endswith(".single"))]  # one lane has no half to leave out


@pytest.mark.parametrize("cell,plant", FAULTS, ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, plant):
    result = run_small(monkeypatch, cell, plant)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def ca_count_altered(sim, t, real):
    real(sim, t)
    sim.state.metrics.scaled_up_nodes.add_(1)


@pytest.mark.parametrize("cell", CELLS)
def test_the_ca_counters_are_compared(monkeypatch, cell):
    """A CA count altered where it is produced (a node scaled up that no
    cycle planned), the pods left as they are: the counters differ."""
    result = run_small(monkeypatch, cell, ca_count_altered)
    assert result["correct"] is False and result["checks"]["counters_differing"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    spec = small_spec(cell)
    limits = spec["traffic"]["limits"]
    got = control.readings(spec, 2**31 + 99, 7200.0, "bfloat16")
    assert got["pods_compared"] > 0
    assert got["pods_differing"] > limits["pods_differing"] or got["counters_differing"] > limits["counters_differing"]
    sound = control.readings(spec, 2**31 + 99, 7200.0, "float32")
    assert sound["pods_differing"] == 0 and sound["counters_differing"] == 0


def test_the_horizon_guard_fails_a_run_that_reaches_the_last_fifth(monkeypatch):
    """A window that reaches the last 20 % of the trace's horizon ends the
    run without a result (here: steps that take no time)."""
    with pytest.raises(SystemExit, match="past 80% of the trace"):
        run_small(monkeypatch, CELLS[0], lambda sim, t, real: None)
