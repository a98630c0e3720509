"""fused_event_scatter (ops/csrc/event_scatter.cu): reads the chunk's
validity flags, each valid event's 16 B and the node and pod rows it
scatters into; one operation an event."""

NAMES = ("event_scatter_kernel",)


def need(C: int, N: int, P: int, E: int, n_valid: int):
    return C * E + 16 * n_valid + 2 * C * (5 * N + 12 * P), n_valid
