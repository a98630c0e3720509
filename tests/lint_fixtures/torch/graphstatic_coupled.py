# ktpu: step-module
"""Seeded graphstatic violations for the port's lint: a call that forwards
one coupled window-program keyword but not the others, and a keyword that
names no parameter of the step function."""


def window_body(state, plan, profile=None, faults=None, profile_terms=None):
    return state


def run_scheduling_cycle(state, K, profile=None, faults=None, profile_terms=None):
    return state


def drive(state, plan, sim):
    state = window_body(state, plan, profile=sim.profile)  # BAD: faults, profile_terms missing
    state = run_scheduling_cycle(state, 8, profile=sim.profile, faults=sim.faults, terms=None)  # BAD: unknown keyword, and profile_terms missing
    state = window_body(state, plan, profile=sim.profile, faults=sim.faults, profile_terms=sim.profile_terms)  # fine
    return window_body(state, plan)  # fine: none of them
