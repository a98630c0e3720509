"""PyTorch/CUDA port of the batched Kubernetes-cluster simulator.

A second package beside the JAX reference (`kubernetriks_tpu`): the
scheduling path (trace events, pod finishes, one scheduling cycle per
window over C clusters at once, on the megakernel, two-kernel or sorted
cycle route), the autoscalers (HPA pod groups and the cluster autoscaler)
and trace replays (Alibaba v2017 and generic YAML traces, `cli.py`) in
PyTorch, with a hand-written CUDA kernel for each of the reference's eight
Pallas kernels (ops/). Imports torch, numpy and yaml only — never jax and
never the JAX package; the host modules it needs are its own copies.

Entry points (`batched.engine.build_batched_from_traces`,
`cli.build_batched_simulation`, the engine's `step_until_time` /
`run_to_completion` / `metrics_summary`, `python -m
kubernetriks_tpu_torch.cli`) run on `torch.device("cuda")` unless the
caller passes `device="cpu"`; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""

__version__ = "0.1.0"
