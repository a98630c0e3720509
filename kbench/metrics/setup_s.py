"""Process start to the window's first span: inputs, engine build, graph
captures, warm-up."""


def read(run):
    return run.setup_s
