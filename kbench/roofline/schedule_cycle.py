"""fused_schedule_cycle (ops/csrc/schedule_cycle.cu), the sorted route's
cycle: the node rows (9 B a node, read; 8 B written), the K candidate
flags and 6 B a candidate row, each live row's requests (8 B); each live
row `node_ops` operations a node."""

NAMES = ("schedule_cycle_kernel",)


def need(C: int, N: int, K: int, n_live: int, node_ops: int = 16):
    return 9 * C * N + C * K + 8 * n_live + 8 * C * N + 6 * C * K, node_ops * N * n_live
