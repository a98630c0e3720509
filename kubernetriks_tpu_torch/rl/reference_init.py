"""The JAX package's initial MLP weights, reproduced without JAX.

The reference's PPOTrainer(seed=s) starts from `init_policy(init_rng)`:
`rng = jax.random.PRNGKey(s)`, `(rng, init_rng) = jax.random.split(rng)`,
then flax's Dense layers draw lecun-normal kernels (a normal truncated to
[-2, 2], scaled to variance 1 / fan_in) from keys that flax folds in from
each layer's name and a per-layer counter. This module recomputes those
draws in numpy: JAX's threefry-2x32 PRNG (with `jax_threefry_partitionable`
on, the default of JAX 0.5 and later), `split`, `fold_in`, the uniform and
truncated-normal samplers, and flax's SHA-1 folding of the scope path. The
float32 `erf` / `erf_inv` of the truncated normal are taken from float64
and rounded, so a weight may differ from flax's in its last bits
(tests/test_torch_rl.py holds them within rtol 1e-6).

The port's own trainer draws its weights from a torch.Generator; this is
for runs that must start where the reference's do (chip_smoke.py phase
23c, the learning proof: its gates compare the trained policy with the
untrained one, so the untrained weights are part of the experiment).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# flax's lecun_normal: the truncated draw's standard deviation.
_TRUNC_STD = np.float32(0.87962566103423978)


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2): 20 rounds, a key injection every 4 (jax._src.prng
    `_threefry2x32_lowering`)."""
    ks = (U32(k1), U32(k2), U32(k1) ^ U32(k2) ^ U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, U32) + ks[0], np.asarray(x2, U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << U32(r)) | (x[1] >> U32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): the seed's high and low 32 bits."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split: (num, 2) keys, the hash of the counters 0..num-1."""
    hi, lo = threefry2x32(key[0], key[1], np.zeros(num, U32), np.arange(num, dtype=U32))
    return np.stack([hi, lo], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in: the hash of the counter pair (0, data)."""
    hi, lo = threefry2x32(key[0], key[1], np.zeros(1, U32), np.array([data], U32))
    return np.array([hi[0], lo[0]], U32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32 random bits an element: the hash of the row-major counters,
    its two words xored."""
    n = int(np.prod(shape))
    hi, lo = threefry2x32(key[0], key[1], np.zeros(n, U32), np.arange(n, dtype=U32))
    return (hi ^ lo).reshape(shape)


def uniform(key: np.ndarray, shape, minval: np.float32, maxval: np.float32) -> np.ndarray:
    """jax.random.uniform in float32: 23 random mantissa bits in [1, 2),
    less 1, scaled to [minval, maxval)."""
    bits = (random_bits(key, shape) >> U32(9)) | U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    # XLA:CPU contracts the scale and shift into one fused multiply-add:
    # the float64 product of two float32 values is exact, one rounding.
    scaled = (floats.astype(np.float64) * np.float64(maxval - minval) + np.float64(minval)).astype(np.float32)
    return np.maximum(minval, scaled)


def truncated_normal(key: np.ndarray, shape, lower: float = -2.0, upper: float = 2.0) -> np.ndarray:
    """jax.random.truncated_normal in float32: sqrt(2) erf_inv of a uniform
    draw between erf(lower / sqrt 2) and erf(upper / sqrt 2), clipped to
    the open interval."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a, b = (np.float32(torch.erf(torch.tensor(float(v / sqrt2), dtype=torch.float64))) for v in (lo, hi))
    u = uniform(key, shape, a, b)
    inv = torch.special.erfinv(torch.from_numpy(u.astype(np.float64))).numpy().astype(np.float32)
    return np.clip(sqrt2 * inv, np.nextafter(lo, np.float32(np.inf)), np.nextafter(hi, np.float32(-np.inf)))


def _flax_fold(key: np.ndarray, *suffix) -> np.ndarray:
    """flax's LazyRng.as_jax_rng: fold the SHA-1 of the scope path (the
    elements concatenated, ints big-endian; flax_fix_rng_separator off,
    flax's default) into the key."""
    digest = hashlib.sha1()
    for x in suffix:
        digest.update(x.encode() if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


def lecun_normal(key: np.ndarray, fan_in: int, fan_out: int) -> np.ndarray:
    """flax Dense's default kernel, (fan_in, fan_out) float32."""
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNC_STD
    return truncated_normal(key, (fan_in, fan_out)) * stddev


def reference_mlp_init(seed: int, hidden: int = 64, layers: int = 2, features: int = 6) -> Dict[str, Dict]:
    """The flax tree of the reference's PPOTrainer(seed=seed,
    policy_kind="mlp") initial weights (numpy; convert with
    convert.policy_params_from_flax): Dense_0 .. Dense_{layers-1} the
    trunk, then the logit layer and the two value layers; each kernel
    drawn with its layer's first key (flax's counter 1), biases zero."""
    _, init_rng = split(prng_key(seed))
    shapes = [(features if i == 0 else hidden, hidden) for i in range(layers)]
    shapes += [(hidden, 1), (hidden, hidden), (hidden, 1)]
    params = {}
    for i, (fan_in, fan_out) in enumerate(shapes):
        key = _flax_fold(init_rng, f"Dense_{i}", 1)
        params[f"Dense_{i}"] = {
            "kernel": lecun_normal(key, fan_in, fan_out),
            "bias": np.zeros((fan_out,), np.float32),
        }
    return {"params": params}
