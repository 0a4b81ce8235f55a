"""Helpers the port's flax parity tests share: flax variable trees filled
from a numpy seed, and flax's NHWC arrays moved to the port's NCHW. Not a
test module."""

import jax
import numpy as np


def nchw(a, lead=1):
    """``a`` with its last (channel) axis moved to ``lead``."""
    return np.moveaxis(np.asarray(a), -1, lead)


def fill(shapes, seed):
    """Numpy values for a flax ``eval_shape`` tree (params and batch_stats):
    kernels uniform in +-1/sqrt(fan_in), conv biases in +-0.05, BatchNorm
    near the identity with non-trivial running statistics."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            value = rng.uniform(-bound, bound, s.shape)
        elif name in ("scale", "var"):
            value = rng.uniform(0.5, 1.5, s.shape)
        elif name == "bias" and "BatchNorm_0" not in str(path):
            value = rng.uniform(-0.05, 0.05, s.shape)
        else:  # BatchNorm bias, running mean
            value = rng.normal(0, 0.05, s.shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
