"""Multi-chip sharded serving: batch data-parallel x tensor-parallel.

Batch DP is collective-free (SURVEY.md §5): shard the window batch over
the mesh's ``data`` axis, replicate params, and any family ``forward``
runs SPMD. With ``param_specs`` (a PartitionSpec pytree or a callable
``params -> specs``; see ``asr_jax.parallel.mesh.*_param_specs``) the
params additionally shard over the ``model`` axis — Megatron tensor
parallelism where XLA inserts the psum/all-gathers from the sharding
constraints. Sessions route through this when constructed with ``mesh=``
(CLI ``transcribe/serve --data-parallel N [--tensor-parallel T]``).
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np

from asr_jax.parallel.mesh import batch_sharded, make_mesh, replicated
from asr_jax.parallel.mesh import shard_params as _shard_params


class DataParallelRunner:
    """Pads a batch to a device multiple, shards it, runs ``fn``, and
    un-pads the results."""

    def __init__(self, mesh=None, param_specs=None):
        self.mesh = mesh or make_mesh(model_parallel=1)
        self.n_data = self.mesh.shape["data"]
        self.param_specs = param_specs

    def shard_params(self, params):
        specs = self.param_specs
        if specs is None:
            return jax.device_put(params, replicated(self.mesh))
        if callable(specs):
            specs = specs(params)
        return _shard_params(params, self.mesh, specs)

    def __call__(self, fn: Callable, params, *batch_args):
        """fn(params, *batch_args) with every batch arg sharded on axis 0.
        Batch is padded to a multiple of the data-axis size by repeating
        the last row (masked out by per-sample valid lengths downstream)."""
        b = batch_args[0].shape[0]
        pad = (-b) % self.n_data
        sharded = []
        for a in batch_args:
            a = np.asarray(a)
            if pad:
                a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
            sharded.append(jax.device_put(a, batch_sharded(self.mesh)))
        out = fn(params, *sharded)
        trim = lambda x: x[:b]
        return jax.tree.map(trim, out)
