# ktpu: capture-module
"""Seeded capture violations for the port's lint: tensor trees a captured
graph reads, rebound without rebuilding the executor."""


class Engine:
    def __init__(self, state, statics):
        self._state = state  # fine: the executor is built below
        self.autoscale_statics = statics
        self._executor = WindowExecutor(self)

    def grow(self, wider):
        self._state = wider  # fine: rebuilt below
        self._executor.rebuild()

    def reseed(self, fresh):
        self._state = fresh  # BAD: the graphs keep reading the old buffers

    def retune(self, consts, sim):
        self.consts = consts  # BAD
        sim.autoscale_statics = None  # BAD


class WindowExecutor:
    def __init__(self, sim):
        self.sim = sim

    def rebuild(self):
        pass
