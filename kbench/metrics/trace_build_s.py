"""The harness's span around input generation and the engine's build."""


def read(run):
    return run.trace_build_s
