"""Multi-layer LSTM cell (torch gate layout) for transducer predictors.

Parakeet/Nemotron RNN-T predictors are small stacked LSTMs (reference
``Parakeet/Export_Parakeet_ASR.py:474-517``). Here the per-token step
lives inside the jitted decode loop; gate matmuls are tiny but serial, so
they are computed as fused single GEMMs per layer.

Torch weight layout: ``w_ih (4H, I)``, ``w_hh (4H, H)``, gates ordered
[input, forget, cell(g), output]. Stored transposed here: ``w_ih (I, 4H)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lstm_cell(x: jnp.ndarray, h: jnp.ndarray, c: jnp.ndarray, p: dict):
    """One LSTM cell step. x (B, I); h/c (B, H). Returns (h', c')."""
    gates = jnp.dot(x, p["w_ih"]) + p["b_ih"] + jnp.dot(h, p["w_hh"]) + p["b_hh"]
    i, f, g, o = jnp.split(gates, 4, axis=-1)
    i = jax.nn.sigmoid(i)
    f = jax.nn.sigmoid(f)
    g = jnp.tanh(g)
    o = jax.nn.sigmoid(o)
    c2 = f * c + i * g
    h2 = o * jnp.tanh(c2)
    return h2, c2


def lstm_step_stack(x: jnp.ndarray, h: jnp.ndarray, c: jnp.ndarray, layers: tuple):
    """One step through stacked LSTM layers. h/c: (L, B, H)."""
    hs, cs = [], []
    y = x
    for li, p in enumerate(layers):
        h2, c2 = lstm_cell(y, h[li], c[li], p)
        hs.append(h2)
        cs.append(c2)
        y = h2
    return y, jnp.stack(hs), jnp.stack(cs)


def init_lstm_params(rng: jax.Array, input_size: int, hidden: int, num_layers: int, dtype=jnp.float32):
    keys = iter(jax.random.split(rng, 4 * num_layers + 1))
    layers = []
    for li in range(num_layers):
        i = input_size if li == 0 else hidden
        layers.append(
            {
                "w_ih": (jax.random.normal(next(keys), (i, 4 * hidden)) * (i ** -0.5)).astype(dtype),
                "w_hh": (jax.random.normal(next(keys), (hidden, 4 * hidden)) * (hidden ** -0.5)).astype(dtype),
                "b_ih": jnp.zeros((4 * hidden,), dtype),
                "b_hh": jnp.zeros((4 * hidden,), dtype),
            }
        )
    return tuple(layers)
