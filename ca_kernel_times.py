#!/usr/bin/env python3
"""Time the two cluster-autoscaler kernels on seeded inputs on one card.

    python3 ca_kernel_times.py [--package-root DIR]

Imports kubernetriks_tpu_torch from DIR (default: the checkout beside this
script), so one call on the card can time two checkouts' kernels on the
same inputs (before and after a change; chip_smoke.py times only its own
checkout's). The inputs come from ca_inputs.py beside this script, at the
widths of the paths that launch the kernels:

  - scale-down at the replay's width (C=1, N=1 713, S=400, K=8): a walk
    that attempts (about half the candidates alive and under the
    threshold, 1-8 pods each, some rollbacks), and one where no candidate
    attempts (each dead, pending, over the threshold or over K pods); at
    the autoscaler path's width (C=256, N=96, S=64, K=8);
  - scale-up at the replay's width (C=1, Gn=1, K=64, S=400) with every
    cache row valid (packing) and with none; at the autoscaler path's
    (C=256, Gn=1, K=64, S=64).

Each case is held against its plain version exactly (it fails otherwise),
then timed as chip_smoke.py times a kernel: CUDA-graph replays between CUDA
events, cycling over input copies that overrun the L2 cache. Prints the
card's name and power limit, then one JSON line:
{"package": path, "card": ..., "times": {case: ms}}. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

DOWN_CASES = {
    "fused_ca_scale_down (replay width, attempting)": dict(C=1, N=1713, S=400, K=8, edge="attempting"),
    "fused_ca_scale_down (replay width, none attempts)": dict(C=1, N=1713, S=400, K=8, edge="none_eligible"),
    "fused_ca_scale_down (autoscaler width)": dict(C=256, N=96, S=64, K=8),
}
UP_CASES = {
    "fused_ca_scale_up (replay width, packing)": dict(C=1, G=1, K=64, S=400, edge="all_valid"),
    "fused_ca_scale_up (replay width, no valid row)": dict(C=1, G=1, K=64, S=400, edge="none_valid"),
    "fused_ca_scale_up (autoscaler width)": dict(C=256, G=1, K=64, S=64),
}
SEED = 11


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(HERE))
    opts = ap.parse_args()
    root = Path(opts.package_root).resolve()
    if not (root / "kubernetriks_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"ca_kernel_times: no kubernetriks_tpu_torch under {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("ca_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import kubernetriks_tpu_torch
    from kubernetriks_tpu_torch.ops import autoscale_kernel as ak

    if Path(kubernetriks_tpu_torch.__file__).resolve().parent.parent != root:
        print(f"ca_kernel_times: imported {kubernetriks_tpu_torch.__file__}, not from {root}", file=sys.stderr)
        return 2
    from ca_inputs import ca_down_inputs, ca_up_inputs
    from chip_smoke import L2_BYTES, graph_ms, nbytes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")

    def timed(kernel, plain, args, kwargs):
        outs = kernel(*args, **kwargs)
        want = plain(*args, **kwargs)
        torch.cuda.synchronize()
        outs = outs if isinstance(outs, tuple) else (outs,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(outs, want)):
            raise SystemExit(f"{kernel.__name__} disagrees with its plain version")
        n = max(1, -(-2 * L2_BYTES // max(nbytes(args), 1)))
        sets = [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]
        return graph_ms([lambda a=a: kernel(*a, **kwargs) for a in sets])

    times = {}
    for label, kw in DOWN_CASES.items():
        args, K = ca_down_inputs(SEED, **kw)
        times[label] = timed(
            ak.fused_ca_scale_down, ak.ca_scale_down_plain,
            tuple(torch.from_numpy(a).to(dev) for a in args), {"k_sd": K},
        )
        print(f"  {label}: {times[label]:.5f} ms", flush=True)
    for label, kw in UP_CASES.items():
        args, S = ca_up_inputs(SEED, **kw)
        times[label] = timed(
            ak.fused_ca_scale_up, ak.ca_scale_up_plain,
            tuple(torch.from_numpy(a).to(dev) for a in args), {"n_slots": S},
        )
        print(f"  {label}: {times[label]:.5f} ms", flush=True)
    print(json.dumps({"package": str(root), "card": smi, "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
