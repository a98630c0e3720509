"""Seeded envflags violations for the port's lint: a direct read of a
registered flag outside flags.py, and reads of unregistered names."""

import os


def stream_enabled():
    env = os.environ.get("KTPU_STREAM")  # BAD: bypasses the registry
    return env != "0" if env is not None else None


def mystery():
    return os.getenv("KTPU_NOT_REGISTERED"), "KUBERNETRIKS_SECRET_MODE" in os.environ  # BAD: unregistered
