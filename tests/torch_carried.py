"""Flax MonoRec weights carried into the port for the CLI tests: drawn once
with ``init(PRNGKey(3))`` at 32x64, written as a JAX (orbax) checkpoint for
the JAX CLIs and as the port's ``.pth`` (``train/checkpoints.py``) for the
port's, so both evaluate the same function. Not a test module."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import torch

from monorec_tpu.models import MonoRec as JMonoRec
from monorec_tpu.models import MonoRecConfig as JConfig
from monorec_tpu_torch.convert import state_dict_from_flax
from monorec_tpu_torch.data.synthetic import make_batch
from monorec_tpu_torch.models import MonoRec, MonoRecConfig
from monorec_tpu_torch.train.checkpoints import save_checkpoint


def write_checkpoints(root, **model_args):
    """(JAX checkpoint dir, port checkpoint file, flax variables) of a
    MonoRec with ``model_args``."""
    root = Path(root)
    model = JMonoRec(JConfig(**model_args))
    batch = {k: jnp.asarray(v) for k, v in make_batch(1, 32, 64, 2).items()}
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda b: model.init({"params": jax.random.PRNGKey(3)}, b, False))(batch))
    jax_dir = root / "jax_checkpoint"
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(jax_dir.resolve(), {"params": variables["params"],
                                       "batch_stats": variables["batch_stats"]})
    port = MonoRec(MonoRecConfig(**model_args))
    port.load_state_dict(state_dict_from_flax(variables["params"], variables["batch_stats"]))
    port_file = save_checkpoint(root / "checkpoint.pth", port,
                                torch.optim.SGD(port.parameters(), lr=0.0), 0, 0.0, {})
    return jax_dir, port_file, variables
