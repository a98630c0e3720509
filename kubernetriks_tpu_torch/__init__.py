"""PyTorch/CUDA port of the batched Kubernetes-cluster simulator.

A second package beside the JAX reference (`kubernetriks_tpu`): the dense
scheduling path (trace events, pod finishes, one scheduling cycle per
window over C clusters at once) and the autoscalers (HPA pod groups and
the cluster autoscaler) in PyTorch, with hand-written CUDA kernels for the
five hot loops (ops/). Imports torch, numpy and yaml only — never jax and
never the JAX package; the host modules it needs are its own copies.

Entry points (`batched.engine.build_batched_from_traces`, the engine's
`step_until_time` / `metrics_summary`) run on `torch.device("cuda")`
unless the caller passes `device="cpu"`; on the CPU every kernel wrapper
runs its plain PyTorch version.
"""

__version__ = "0.1.0"
