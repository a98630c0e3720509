# ktpu: threaded
"""Seeded feederlock violations for the port's lint: a CUDA synchronize
and an Event's wait while HOLDING the ring lock, an unlocked touch of a
shared attribute, and a lock-held helper called outside the lock."""

import threading

import torch


class Feeder:
    _UNDER_LOCK = ("_publish",)

    def __init__(self):
        self._cond = threading.Condition()
        self._ready = torch.cuda.Event() if torch.cuda.is_available() else None
        self.produced = 0

    def _publish(self):
        self.produced += 1  # fine: declared in _UNDER_LOCK
        self._cond.notify_all()

    def produce(self):
        with self._cond:
            torch.cuda.synchronize()  # BAD: blocks both threads
            self._ready.synchronize()  # BAD: a foreign wait under the lock
            self._publish()
        self._publish()  # BAD: a lock-held helper outside the lock

    def count(self):
        return self.produced  # BAD: unlocked read of a shared attribute
