"""The harness's span around precompile_pieces(): every window piece's
CUDA graph captured."""


def read(run):
    return run.capture_s
