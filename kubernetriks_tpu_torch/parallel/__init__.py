"""Model-parallel primitives for the RL policy head, and the simulator's
data parallelism over the cluster batch.

Port of the JAX package's `parallel/`. The simulator needs data
parallelism alone (the cluster axis sharded over a torch.distributed group,
one process a card: parallel/multihost.py and the engine's `mesh=`). The
policy network is where tensor and sequence parallelism are real:
parallel/ring.py gives ring attention (sequence parallelism over the node
axis, K/V blocks rotated around the ranks by point-to-point calls), and
rl/attention_policy.make_sharded_apply combines it with Megatron-style
tensor parallelism of the FFN's hidden dimension on a (data, seq, model)
mesh.
"""

from kubernetriks_tpu_torch.parallel.ring import full_attention, ring_attention

__all__ = ["full_attention", "ring_attention"]
