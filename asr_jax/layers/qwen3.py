"""Qwen3-style decoder stack: RMSNorm + GQA (per-head q/k RMSNorm) + RoPE +
gated-SiLU MLP, with fixed-shape KV caches.

Shared by the LLM-decoder ASR families (Qwen3-ASR, Fun-ASR-Nano,
ForcedAligner — reference ``Qwen_ASR/Export_Qwen_ASR.py:145-517,1080-1350``
re-implements exactly this). The reference's export-time folds (RMSNorm
weight absorbed into qkv/gate_up, sqrt-scale splits) stay unfolded here.

Works on input **embeddings** (the ASR families feed mixed audio/text
embeds), with a causal mask supporting dynamic prompt lengths in a static
buffer (padded prompt slots are later overwritten by generated tokens).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.layers.attention import NEG_INF
from asr_jax.layers.norms import rms_norm
from asr_jax.layers.rope import apply_rope, rope_tables
from asr_jax.layers.transformer import dense


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden: int = 1024
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    ffn_dim: int = 3072
    rms_eps: float = 1e-6
    rope_theta: float = 5_000_000.0
    max_seq_len: int = 2048
    attention_bias: bool = False
    qk_norm: bool = True
    tie_embeddings: bool = True


def init_params(cfg: Qwen3Config, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 4096))
    h = cfg.hidden

    def lin(i, o, bias=False):
        p = {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def layer():
        p = {
            "input_norm": {"scale": jnp.ones((h,), dtype)},
            "attn": {
                "q": lin(h, cfg.num_heads * cfg.head_dim, cfg.attention_bias),
                "k": lin(h, cfg.num_kv_heads * cfg.head_dim, cfg.attention_bias),
                "v": lin(h, cfg.num_kv_heads * cfg.head_dim, cfg.attention_bias),
                "o": lin(cfg.num_heads * cfg.head_dim, h),
            },
            "post_norm": {"scale": jnp.ones((h,), dtype)},
            "mlp": {"gate": lin(h, cfg.ffn_dim), "up": lin(h, cfg.ffn_dim), "down": lin(cfg.ffn_dim, h)},
        }
        if cfg.qk_norm:
            p["attn"]["q_norm"] = {"scale": jnp.ones((cfg.head_dim,), dtype)}
            p["attn"]["k_norm"] = {"scale": jnp.ones((cfg.head_dim,), dtype)}
        return p

    return {
        "embed": (jax.random.normal(next(keys), (cfg.vocab_size, h)) * 0.02).astype(dtype),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_norm": {"scale": jnp.ones((h,), dtype)},
        # lm_head absent when tie_embeddings (uses embed.T)
        **({} if cfg.tie_embeddings else {"lm_head": lin(h, cfg.vocab_size)}),
    }


def make_kv_state(cfg: Qwen3Config, batch: int, t_max: int, dtype=jnp.float32) -> dict:
    return {
        "layers": tuple(
            {
                "k": jnp.zeros((batch, t_max, cfg.num_kv_heads, cfg.head_dim), dtype),
                "v": jnp.zeros((batch, t_max, cfg.num_kv_heads, cfg.head_dim), dtype),
            }
            for _ in range(cfg.num_layers)
        )
    }


def _attention(q, k_cache, v_cache, bias, num_kv_groups):
    """GQA over the full cache with additive bias (B,1,S,Tmax)."""
    b, s, hq, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, s, hkv, num_kv_groups, d)
    scores = jnp.einsum("bshgd,bthd->bhgst", qg, k_cache).astype(jnp.float32) * (d ** -0.5)
    scores = scores + bias[:, :, None] if bias.ndim == 4 else scores + bias
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    out = jnp.einsum("bhgst,bthd->bshgd", probs, v_cache)
    return out.reshape(b, s, hq * d)


def decoder_pass(
    params: dict,
    cfg: Qwen3Config,
    x: jnp.ndarray,
    state: dict,
    pos: jnp.ndarray,
    bias: jnp.ndarray,
    pos_offset: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, dict]:
    """Run S embeddings through all layers, updating KV caches at ``pos``.

    Args:
      x: (B, S, H) input embeddings.
      state: KV caches (B, T_max, Hkv, D) per layer.
      pos: scalar int32 — slot of x[:, 0].
      bias: (B, 1, S, T_max) additive attention bias (causal + validity).
      pos_offset: optional (B,) int32 — per-row amount SUBTRACTED from the
        slot index to get the RoPE position (left-padded batch layout:
        offset = pad width, so each row's logical positions start at 0
        exactly like the unpadded computation; pad-slot phases are clipped
        to 0 and masked out of attention by ``bias``).

    Returns (hidden (B, S, H), new state).
    """
    t_max = state["layers"][0]["k"].shape[1]
    cs = jnp.asarray(rope_tables(t_max, cfg.head_dim, cfg.rope_theta))
    s = x.shape[1]
    if pos_offset is None:
        cos = jax.lax.dynamic_slice(cs[0], (pos, 0), (s, cfg.head_dim))
        sin = jax.lax.dynamic_slice(cs[1], (pos, 0), (s, cfg.head_dim))
    else:
        logical = jnp.clip(
            pos + jnp.arange(s, dtype=jnp.int32)[None, :] - pos_offset[:, None], 0, t_max - 1
        )  # (B, S)
        cos = jnp.take(cs[0], logical, axis=0)  # (B, S, D)
        sin = jnp.take(cs[1], logical, axis=0)
    groups = cfg.num_heads // cfg.num_kv_heads
    b = x.shape[0]
    new_layers = []
    qd = cfg.num_heads * cfg.head_dim
    kd = cfg.num_kv_heads * cfg.head_dim
    for p, lstate in zip(params["layers"], state["layers"]):
        y = rms_norm(x, p["input_norm"]["scale"], cfg.rms_eps)
        if "qkv" in p["attn"]:
            # fused projection (fuse_params): one matmul, split columns —
            # equals three separate dots up to float summation order
            qkv = dense(y, p["attn"]["qkv"])
            q = qkv[..., :qd].reshape(b, s, cfg.num_heads, cfg.head_dim)
            k = qkv[..., qd:qd + kd].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
            v = qkv[..., qd + kd:].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        else:
            q = dense(y, p["attn"]["q"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
            k = dense(y, p["attn"]["k"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
            v = dense(y, p["attn"]["v"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, p["attn"]["q_norm"]["scale"], cfg.rms_eps)
            k = rms_norm(k, p["attn"]["k_norm"]["scale"], cfg.rms_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache = jax.lax.dynamic_update_slice(lstate["k"], k.astype(lstate["k"].dtype), (0, pos, 0, 0))
        v_cache = jax.lax.dynamic_update_slice(lstate["v"], v.astype(lstate["v"].dtype), (0, pos, 0, 0))
        attn = _attention(q, k_cache, v_cache, bias, groups)
        x = x + dense(attn, p["attn"]["o"])
        y = rms_norm(x, p["post_norm"]["scale"], cfg.rms_eps)
        if "gateup" in p["mlp"]:
            gu = dense(y, p["mlp"]["gateup"])
            h = jax.nn.silu(gu[..., : cfg.ffn_dim]) * gu[..., cfg.ffn_dim:]
        else:
            h = jax.nn.silu(dense(y, p["mlp"]["gate"])) * dense(y, p["mlp"]["up"])
        x = x + dense(h, p["mlp"]["down"])
        new_layers.append({"k": k_cache, "v": v_cache})
    return x, {"layers": tuple(new_layers)}


def fuse_params(params: dict, cfg: Qwen3Config) -> dict:
    """Concat per-layer q/k/v -> qkv and gate/up -> gateup along the output
    dimension: 7 -> 4 matmuls per layer.  Batch-1 AR decode dispatches
    ~200 small matvecs per token whose per-kernel overhead rivals the
    weight streaming itself; fewer, wider matmuls cut that fixed cost.

    Column concatenation preserves every weight (and every dequantized
    block-quant value) bit-for-bit; the fused dot equals the split dots in
    exact arithmetic and differs only by XLA's summation order in floats
    (~1e-7 rel, the same class of difference as any fusion change).
    Leaves that cannot fuse (mixed bits/block/packing, dynamic-activation
    int8) stay split.  A None / layer-less params tree passes through
    (prompt-only session tests construct sessions without weights)."""
    if not isinstance(params, dict) or "layers" not in params:
        return params
    from asr_jax.quant.quantize import QuantizedLinear

    def cat(leaves):
        ws = [l["w"] for l in leaves]
        if any("b" in l for l in leaves):
            if not all("b" in l for l in leaves):
                return None
            b = jnp.concatenate([l["b"] for l in leaves], axis=0)
        else:
            b = None
        if all(isinstance(w, jnp.ndarray) for w in ws):
            out = {"w": jnp.concatenate(ws, axis=1)}
        else:
            if not all(isinstance(w, QuantizedLinear) for w in ws):
                return None
            w0 = ws[0]
            key = (w0.bits, w0.block, w0.packed, w0.dynamic)
            if w0.dynamic or any((w.bits, w.block, w.packed, w.dynamic) != key for w in ws):
                return None
            out = {"w": QuantizedLinear(
                jnp.concatenate([w.q for w in ws], axis=1),
                jnp.concatenate([w.scale for w in ws], axis=1),
                jnp.concatenate([w.zero for w in ws], axis=1),
                w0.bits, w0.block, packed=w0.packed)}
        if b is not None:
            out["b"] = b
        return out

    layers = []
    for p in params["layers"]:
        p = dict(p)
        attn = dict(p["attn"])
        if all(k in attn for k in ("q", "k", "v")):
            fused = cat([attn["q"], attn["k"], attn["v"]])
            if fused is not None:
                attn["qkv"] = fused
                del attn["q"], attn["k"], attn["v"]
        mlp = dict(p["mlp"])
        if "gate" in mlp and "up" in mlp:
            fused = cat([mlp["gate"], mlp["up"]])
            if fused is not None:
                mlp["gateup"] = fused
                del mlp["gate"], mlp["up"]
        p["attn"] = attn
        p["mlp"] = mlp
        layers.append(p)
    return {**params, "layers": layers}


def logits_from_normalized(params: dict, cfg: Qwen3Config, y: jnp.ndarray) -> jnp.ndarray:
    """LM-head logits for a hidden state that is ALREADY final-normalized."""
    if cfg.tie_embeddings:
        emb = params["embed"]
        if not isinstance(emb, jnp.ndarray):
            from asr_jax.quant.quantize import embedding_logits

            return embedding_logits(emb, y)
        return jnp.dot(y, emb.T)
    return dense(y, params["lm_head"])


def logits_from_hidden(params: dict, cfg: Qwen3Config, hidden: jnp.ndarray) -> jnp.ndarray:
    y = rms_norm(hidden, params["final_norm"]["scale"], cfg.rms_eps)
    if cfg.tie_embeddings:
        emb = params["embed"]
        if not isinstance(emb, jnp.ndarray):  # QuantizedEmbedding tied head
            from asr_jax.quant.quantize import embedding_logits

            return embedding_logits(emb, y)
        return jnp.dot(y, emb.T)
    return dense(y, params["lm_head"])


def causal_prefill_bias(valid_len: jnp.ndarray, s: int, t_max: int) -> jnp.ndarray:
    """(B,1,S,T_max) bias for prefill at pos 0: causal + key-validity
    (keys beyond per-sample valid prompt length are masked — they are
    padded slots not yet overwritten by generated tokens)."""
    qpos = jnp.arange(s, dtype=jnp.int32)[:, None]
    kpos = jnp.arange(t_max, dtype=jnp.int32)[None, :]
    causal = kpos <= qpos  # (S, T_max)
    keep = causal[None] & (kpos[None] < valid_len[:, None, None])
    return jnp.where(keep, 0.0, NEG_INF)[:, None].astype(jnp.float32)


def step_bias(valid_len: jnp.ndarray, pos: jnp.ndarray, t_max: int) -> jnp.ndarray:
    """(B,1,1,T_max) bias for a single-token step at slot ``pos``: attends
    the valid prompt prefix and all generated slots up to ``pos``."""
    kpos = jnp.arange(t_max, dtype=jnp.int32)[None, :]
    keep = (kpos < valid_len[:, None]) | ((kpos >= valid_len[:, None]) & (kpos <= pos))
    return jnp.where(keep, 0.0, NEG_INF)[:, None, None].astype(jnp.float32)


def left_prefill_bias(shift: jnp.ndarray, s: int, t_max: int) -> jnp.ndarray:
    """(B,1,S,T_max) prefill bias for a LEFT-padded prompt occupying slots
    ``[shift_b, s)``: causal + pad-key masking.  Left padding lets rows of
    unequal prompt length decode in lockstep from one scalar position —
    RoPE attention depends only on position differences, so the per-row
    shift is mathematically a no-op.

    Pad query rows (qpos < shift) additionally attend their OWN position:
    otherwise every key would be masked and their softmax would only stay
    finite because NEG_INF is a finite -1e30 — a true -inf (or a masked
    softmax helper) would give NaN that 0-weight attention cannot absorb
    (0 * NaN = NaN) and poison real rows via later layers' k/v. The
    attend-self output is garbage but finite, and pad-slot keys are masked
    for every real query anyway."""
    qpos = jnp.arange(s, dtype=jnp.int32)[:, None]
    kpos = jnp.arange(t_max, dtype=jnp.int32)[None, :]
    causal = kpos <= qpos  # (S, T_max)
    # (1,S,T) & ((1,1,T) >= (B,1,1) -> (B,1,T)) -> (B,S,T)
    keep = causal[None] & (kpos[None] >= shift[:, None, None])
    pad_self = (qpos < shift[:, None, None]) & (kpos[None] == qpos[None])
    keep = keep | pad_self
    return jnp.where(keep, 0.0, NEG_INF)[:, None].astype(jnp.float32)


def left_step_bias(shift: jnp.ndarray, pos: jnp.ndarray, t_max: int) -> jnp.ndarray:
    """(B,1,1,T_max) step bias for the left-padded layout: attends
    ``[shift_b, pos]`` (prompt + all generated slots), masks pad slots."""
    kpos = jnp.arange(t_max, dtype=jnp.int32)[None, :]
    keep = (kpos >= shift[:, None]) & (kpos <= pos)
    return jnp.where(keep, 0.0, NEG_INF)[:, None, None].astype(jnp.float32)


def rowwise_step_bias(pos: jnp.ndarray, t_max: int) -> jnp.ndarray:
    """(B,1,1,T_max) step bias for COMPACT per-row cache layouts (every
    row's prompt starts at cache slot 0 — continuous batching): key slot
    ``t`` attends iff ``t <= pos_b``. NEG_INF is the finite -1e30; rows
    with ``pos_b >= 0`` always keep at least slot 0 attendable."""
    kpos = jnp.arange(t_max, dtype=jnp.int32)[None, :]
    keep = kpos <= pos[:, None]
    return jnp.where(keep, 0.0, NEG_INF)[:, None, None].astype(jnp.float32)


def decoder_step_rowwise(
    params: dict,
    cfg: Qwen3Config,
    x: jnp.ndarray,
    state: dict,
    pos: jnp.ndarray,
    active: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, dict]:
    """One decode token through all layers with PER-ROW cache positions.

    The lockstep decoder (:func:`decoder_pass`) writes every row's KV at
    one scalar slot — rows must share a global step counter, which forces
    whole-batch barriers. Continuous batching (requests joining/leaving a
    running decode batch, ``parallel/llm_batcher.py``) instead gives each
    slot its own compact cache: row ``b``'s prompt occupies slots
    ``[0, L_b)`` and generation continues at ``pos_b`` independently.
    Writes become a per-row scatter (``mode="drop"``: inactive rows are
    parked at index ``t_max`` and write nowhere), RoPE phases index the
    per-row position directly (cache slot == logical position), and the
    bias is :func:`rowwise_step_bias`.

    Per-row math is IDENTICAL to running that row alone through
    :func:`decoder_pass` — masked slots contribute exactly-zero attention
    probability and zero v-rows, so reductions agree bitwise (tested in
    ``tests/test_llm_batcher.py``).

    Args:
      x: (B, 1, H) current-token embeddings.
      pos: (B,) int32 cache slot to write (== tokens so far in the row).
      active: optional (B,) bool; inactive rows neither write KV nor
        advance (their returned hidden is garbage — callers mask it).

    Returns (hidden (B, 1, H), new state).
    """
    t_max = state["layers"][0]["k"].shape[1]
    cs = jnp.asarray(rope_tables(t_max, cfg.head_dim, cfg.rope_theta))
    logical = jnp.clip(pos, 0, t_max - 1)
    cos = jnp.take(cs[0], logical, axis=0)[:, None]  # (B, 1, D)
    sin = jnp.take(cs[1], logical, axis=0)[:, None]
    bias = rowwise_step_bias(pos, t_max)
    b = x.shape[0]
    bidx = jnp.arange(b, dtype=jnp.int32)
    # parked index t_max + mode="drop" => no write for inactive rows
    wpos = logical if active is None else jnp.where(active, logical, t_max)
    groups = cfg.num_heads // cfg.num_kv_heads
    qd = cfg.num_heads * cfg.head_dim
    kd = cfg.num_kv_heads * cfg.head_dim
    new_layers = []
    for p, lstate in zip(params["layers"], state["layers"]):
        y = rms_norm(x, p["input_norm"]["scale"], cfg.rms_eps)
        if "qkv" in p["attn"]:
            qkv = dense(y, p["attn"]["qkv"])
            q = qkv[..., :qd].reshape(b, 1, cfg.num_heads, cfg.head_dim)
            k = qkv[..., qd:qd + kd].reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
            v = qkv[..., qd + kd:].reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
        else:
            q = dense(y, p["attn"]["q"]).reshape(b, 1, cfg.num_heads, cfg.head_dim)
            k = dense(y, p["attn"]["k"]).reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
            v = dense(y, p["attn"]["v"]).reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, p["attn"]["q_norm"]["scale"], cfg.rms_eps)
            k = rms_norm(k, p["attn"]["k_norm"]["scale"], cfg.rms_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache = lstate["k"].at[bidx, wpos].set(
            k[:, 0].astype(lstate["k"].dtype), mode="drop")
        v_cache = lstate["v"].at[bidx, wpos].set(
            v[:, 0].astype(lstate["v"].dtype), mode="drop")
        attn = _attention(q, k_cache, v_cache, bias, groups)
        x = x + dense(attn, p["attn"]["o"])
        y = rms_norm(x, p["post_norm"]["scale"], cfg.rms_eps)
        if "gateup" in p["mlp"]:
            gu = dense(y, p["mlp"]["gateup"])
            h = jax.nn.silu(gu[..., : cfg.ffn_dim]) * gu[..., cfg.ffn_dim:]
        else:
            h = jax.nn.silu(dense(y, p["mlp"]["gate"])) * dense(y, p["mlp"]["up"])
        x = x + dense(h, p["mlp"]["down"])
        new_layers.append({"k": k_cache, "v": v_cache})
    return x, {"layers": tuple(new_layers)}
