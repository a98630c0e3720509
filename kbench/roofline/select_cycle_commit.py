"""fused_select_cycle_commit (ops/csrc/select_cycle_commit.cu), the dense
routes' megakernel: the eligible mask, the eligible pods' keys and
requests (12 B each), each pick's requests (8 B), the node rows read (9 B
a node) and written (8 B), the commit's 16 B a pick, the pod rows (24 B a
slot) and the stats rows (20 B a cluster). Operations: ordering `picks`
of `depth` keys needs log2(depth! / (depth - picks)!) compares of ~3
operations, and each pick `node_ops` operations a node (16 for the
default profile)."""

import math

NAMES = ("select_cycle_commit_kernel",)


def need(C: int, N: int, P: int, depth, picks, node_ops: int = 16):
    """`depth`, `picks`: per cluster (sequences of C numbers)."""
    compares = sum((math.lgamma(d + 1) - math.lgamma(d - k + 1)) / math.log(2) for d, k in zip(depth, picks))
    n_picks = int(sum(picks))
    need_bytes = C * P + 12 * int(sum(depth)) + 8 * n_picks + 17 * C * N + 16 * n_picks + 24 * C * P + 20 * C
    return need_bytes, int(3 * compares) + node_ops * N * n_picks
