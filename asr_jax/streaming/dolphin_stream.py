"""Dolphin CN-Dialect streaming: chunked E-Branchformer + streaming CTC +
AR rescoring decoder.

Capability parity with reference
``Dolphin/CN-Dialect-Streaming/Export_Dolphin_CN_Dialect_Streaming.py``
(3,794 LoC). Per 16-encoder-frame (640 ms) chunk:

- Kaldi fbank + CMVN over an overlapped audio window (state carries the
  audio tail so subsampling receptive fields are exact across chunks);
- Conv2d (k3, s2, no pad) x2 subsampling + sqrt(d) embed scale;
- E-Branchformer blocks in streaming form: attention over the FULL
  history via per-layer append-only K/V buffers (reference "left=-1
  all-history cache"), simplified rel-pos bias **without** rel-shift
  (``matrix_bd = (q + bias_v) @ pos[:kv_len]`` — ``:344`` "NO rel_shift"),
  **causal** CSGU conv with a carried ``lorder`` tail, and a per-chunk
  left-zero-padded merge fusion conv;
- per-chunk CTC argmax ids (stable streaming text) and per-layer cross-K/V
  appended to buffers for the final AR rescoring decode.

Fixed shapes: history buffers are preallocated to ``max_frames`` with a
valid counter; the reference's unbounded concat-grow caches become
masked writes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig, ar_decode, select_token
from asr_jax.decode.strategies import suppress_tokens
from asr_jax.quant.quantize import embedding_logits
from asr_jax.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_jax.layers.attention import NEG_INF
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import depthwise_conv1d_time
from asr_jax.layers.transformer import dense
from asr_jax.models.dolphin import DolphinConfig


@dataclasses.dataclass(frozen=True)
class DolphinStreamConfig:
    base: DolphinConfig = DolphinConfig()
    chunk_frames: int = 16            # encoder frames per chunk (640 ms)
    max_frames: int = 752             # total encoder frames (~30 s)
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def mel_per_chunk(self) -> int:
        return self.chunk_frames * 4  # new mel frames per chunk

    @property
    def window_mel(self) -> int:
        # Encoder frame J of chunk c reads mel [4*(J-kc), 4*(J-kc)+6] within
        # the window (two k3/s2 convs, no padding): 3 lookahead frames.
        return self.mel_per_chunk + 3

    @property
    def window_samples(self) -> int:
        fb = self.fbank
        return (self.window_mel - 1) * fb.hop_length + fb.win_length

    @property
    def advance_samples(self) -> int:
        return self.mel_per_chunk * self.fbank.hop_length


def init_state(cfg: DolphinStreamConfig, dtype=jnp.float32) -> dict:
    b = cfg.base
    csgu_half = b.cgmlp_dim // 2
    return {
        "att_k": jnp.zeros((b.enc_layers, cfg.max_frames, b.enc_heads, b.head_dim), dtype),
        "att_v": jnp.zeros((b.enc_layers, cfg.max_frames, b.enc_heads, b.head_dim), dtype),
        "cnn": jnp.zeros((b.enc_layers, b.csgu_kernel - 1, csgu_half), dtype),
        "cross_k": jnp.zeros((b.dec_layers, cfg.max_frames, b.dec_heads, b.head_dim), dtype),
        "cross_v": jnp.zeros((b.dec_layers, cfg.max_frames, b.dec_heads, b.head_dim), dtype),
        "valid": jnp.asarray(0, jnp.int32),
    }


def _append_rows(buf, new, li: int, start, *, scatter_free: bool):
    """Append ``new`` (n, H, D) rows into layer ``li`` of a stacked history
    buffer (L, T, H, D) at row offset ``start``.

    ``scatter_free=False`` (single stream): a plain ``dynamic_update_slice``
    — writes only the ``n`` new rows and aliases in place through loop
    carries. Under ``vmap`` a batched ``start`` makes that dus lower to a
    scatter, which dominated the vmapped Dolphin tick — so the multistream
    runner passes ``scatter_free=True``: the update becomes a one-hot
    spread (a matmul) plus a row-range ``where`` — dense ops that vectorize
    cleanly with NO batched-index scatter anywhere. (A static flag, not
    ``custom_vmap``: the call boundary custom_vmap introduces blocked the
    in-place aliasing of the single-stream dus.)

    Matches dus clamp semantics (``start`` clamped into [0, T-n]) so
    multistream token streams stay identical to single-stream replay.
    """
    if not scatter_free:
        return jax.lax.dynamic_update_slice(buf, new[None], (li, start, 0, 0))
    T, n = buf.shape[1], new.shape[0]
    start = jnp.clip(start, 0, T - n)
    rows = jnp.arange(T, dtype=start.dtype)
    tgt = start + jnp.arange(n, dtype=start.dtype)            # (n,)
    onehot = (rows[:, None] == tgt[None, :]).astype(new.dtype)  # (T, n)
    spread = jnp.einsum("tn,nhd->thd", onehot, new)
    sel = (rows >= start) & (rows < start + n)
    layer = jnp.where(sel[:, None, None], spread, buf[li])
    return buf.at[li].set(layer)


@functools.lru_cache(maxsize=8)
def _abs_pos_table(max_len: int, d_model: int) -> np.ndarray:
    """espnet positive-position sinusoid rows 0..max_len-1 (interleaved)."""
    from asr_jax.layers.conformer import relative_position_embedding

    pe = relative_position_embedding(max_len, d_model)  # rows: pos max-1..-(max-1)
    return pe[:max_len][::-1].copy()  # rows: pos 0..max_len-1


def precompute_rel_k(params: dict, cfg: DolphinStreamConfig) -> jnp.ndarray:
    """Per-layer projected relative-position keys, shape
    ``(enc_layers, max_frames, enc_heads, head_dim)``.

    ``pos @ rel_k`` is a params-only constant, but the per-chunk step was
    re-projecting the full ``max_frames``-row sinusoid table through every
    layer's ``rel_k`` weight on EVERY tick — ≈60% of per-chunk FLOPs at
    default geometry (12 × 752 × 512² ≈ 4.7 GFLOP/chunk vs ≈3.7 for the
    rest of the step). Sessions compute this once and pass it to
    ``encoder_step``; ``None`` keeps the self-contained in-graph path."""
    b = cfg.base
    pos = jnp.asarray(_abs_pos_table(cfg.max_frames, b.d_model))
    return jnp.stack([
        dense(pos, p["attn"]["rel_k"]).reshape(cfg.max_frames, b.enc_heads,
                                               b.head_dim)
        for p in params["enc_blocks"]])


@functools.partial(jax.jit, static_argnames=("cfg", "scatter_free_writes"))
def encoder_step(params: dict, cfg: DolphinStreamConfig, state: dict,
                 window: jnp.ndarray, rel_k_cache: jnp.ndarray | None = None,
                 scatter_free_writes: bool = False):
    """One chunk window (window_samples,) int16-range (the session slides
    windows by ``advance_samples``, i.e. 3 mel frames of lookahead overlap)
    -> (state', ctc_ids (1, chunk), enc_out (1, chunk, D)).

    ``rel_k_cache``: optional ``precompute_rel_k`` output; hoists the
    position-key projection out of the per-chunk step (same math, computed
    once per session instead of once per tick per layer)."""
    b = cfg.base
    fb = cfg.fbank
    mel = log_mel_fbank(window[None], fb, cfg.window_mel)
    mel = (mel - params["cmvn_mean"]) * params["cmvn_istd"]

    x = mel[..., None]
    sub = params["subsample"]
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, sub["conv0"]["w"], (2, 2), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + sub["conv0"]["b"])
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, sub["conv1"]["w"], (2, 2), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + sub["conv1"]["b"])
    t = x.shape[1]
    x = x.transpose(0, 1, 3, 2).reshape(1, t, -1)
    x = dense(x, sub["out"]) * (b.d_model ** 0.5)
    x = x[:, : cfg.chunk_frames]  # exactly `chunk` new encoder-rate frames

    valid = state["valid"]
    n = cfg.chunk_frames
    max_f = cfg.max_frames
    kv_len_total = valid + n
    kpos = jnp.arange(max_f, dtype=jnp.int32)[None, :]
    key_bias = jnp.where(kpos < kv_len_total, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    pos = jnp.asarray(_abs_pos_table(max_f, b.d_model))

    # History buffers are patched IN PLACE in their stacked (L, T, H, D)
    # form via _append_rows: a dynamic_update_slice single-stream (writes
    # only the new rows, aliases through loop carries); the vmapped
    # multistream runner passes scatter_free_writes=True for the one-hot
    # spread + row-range select — the batched-offset dus otherwise lowers
    # to a scatter, which dominated the vmapped tick.
    att_k, att_v, cnn = state["att_k"], state["att_v"], state["cnn"]
    hd = b.head_dim
    for li, p in enumerate(params["enc_blocks"]):
        # macaron FFN
        y = layer_norm(x, p["ffn_macaron"]["norm"]["scale"], p["ffn_macaron"]["norm"]["bias"])
        x = x + 0.5 * dense(jax.nn.silu(dense(y, p["ffn_macaron"]["w1"])), p["ffn_macaron"]["w2"])
        xn = layer_norm(x, p["norm_mha"]["scale"], p["norm_mha"]["bias"])
        # attention over the full history buffer
        q = dense(xn, p["attn"]["q"]).reshape(1, n, b.enc_heads, hd)
        k_new = dense(xn, p["attn"]["k"]).reshape(n, b.enc_heads, hd)
        v_new = dense(xn, p["attn"]["v"]).reshape(n, b.enc_heads, hd)
        att_k = _append_rows(att_k, k_new, li, valid, scatter_free=scatter_free_writes)
        att_v = _append_rows(att_v, v_new, li, valid, scatter_free=scatter_free_writes)
        k_buf, v_buf = att_k[li], att_v[li]
        rel_k = (rel_k_cache[li] if rel_k_cache is not None else
                 dense(pos, p["attn"]["rel_k"]).reshape(max_f, b.enc_heads, hd))
        qu = q + p["attn"]["bias_u"][None, None]
        qv = q + p["attn"]["bias_v"][None, None]
        ac = jnp.einsum("bqhd,khd->bhqk", qu, k_buf)
        bdm = jnp.einsum("bqhd,khd->bhqk", qv, rel_k)  # NO rel-shift (checkpoint convention)
        scores = (ac + bdm).astype(jnp.float32) * (hd ** -0.5) + key_bias
        probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
        x1 = jnp.einsum("bhqk,khd->bqhd", probs, v_buf).reshape(1, n, b.d_model)
        x1 = dense(x1, p["attn"]["o"])
        # cgMLP branch with causal CSGU conv
        xm = layer_norm(x, p["norm_mlp"]["scale"], p["norm_mlp"]["bias"])
        g0 = jax.nn.gelu(dense(xm, p["cgmlp"]["proj1"]), approximate=False)
        r, g = jnp.split(g0, 2, axis=-1)
        g = layer_norm(g, p["cgmlp"]["csgu"]["norm"]["scale"], p["cgmlp"]["csgu"]["norm"]["bias"])
        g_in = jnp.concatenate([state["cnn"][li][None], g], axis=1)  # (1, lorder + n, half)
        cnn = jax.lax.dynamic_update_slice(
            cnn, g_in[0, -(b.csgu_kernel - 1):][None], (li, 0, 0))
        g = depthwise_conv1d_time(g_in, p["cgmlp"]["csgu"]["conv"]["w"], 0, 0)
        if "b" in p["cgmlp"]["csgu"]["conv"]:
            g = g + p["cgmlp"]["csgu"]["conv"]["b"]
        x2 = dense(r * g, p["cgmlp"]["proj2"])
        # merge with per-chunk left-padded fusion conv
        c = jnp.concatenate([x1, x2], axis=-1)
        fk = p["fusion"]["w"].shape[0]
        fused = depthwise_conv1d_time(c, p["fusion"]["w"], fk - 1, 0)
        if "b" in p["fusion"]:
            fused = fused + p["fusion"]["b"]
        c = c + fused
        x = x + dense(c, p["merge_proj"])
        y = layer_norm(x, p["ffn"]["norm"]["scale"], p["ffn"]["norm"]["bias"])
        x = x + 0.5 * dense(jax.nn.silu(dense(y, p["ffn"]["w1"])), p["ffn"]["w2"])
        x = layer_norm(x, p["norm_final"]["scale"], p["norm_final"]["bias"])

    enc_out = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])
    ctc_ids = jnp.argmax(dense(enc_out, params["ctc"]), axis=-1).astype(jnp.int32)

    # Append per-layer cross-K/V for the rescoring decoder (same in-place
    # stacked-buffer patches as the attention history above).
    cross_k, cross_v = state["cross_k"], state["cross_v"]
    for li, p in enumerate(params["decoder"]["blocks"]):
        k = dense(enc_out, p["cross"]["k"]).reshape(n, b.dec_heads, hd)
        v = dense(enc_out, p["cross"]["v"]).reshape(n, b.dec_heads, hd)
        cross_k = _append_rows(cross_k, k, li, valid, scatter_free=scatter_free_writes)
        cross_v = _append_rows(cross_v, v, li, valid, scatter_free=scatter_free_writes)

    new_state = {
        "att_k": att_k,
        "att_v": att_v,
        "cnn": cnn,
        "cross_k": cross_k,
        "cross_v": cross_v,
        "valid": jnp.minimum(kv_len_total, max_f),
    }
    return new_state, ctc_ids, enc_out


@functools.partial(jax.jit, static_argnames=("cfg", "decode_cfg"))
def rescore_decode(
    params: dict,
    cfg: DolphinStreamConfig,
    state: dict,
    prompt: jnp.ndarray,
    decode_cfg: DecodeConfig,
    rng: jax.Array | None = None,
):
    """Final AR rescoring pass over the accumulated cross-K/V buffers
    (reference PrefillGreedy/DecodeGreedy merged graphs)."""
    from asr_jax.layers.transformer import decoder_block
    from asr_jax.layers.conformer import relative_position_embedding

    b = cfg.base
    valid = state["valid"]
    cross_bias = jnp.where(
        jnp.arange(cfg.max_frames, dtype=jnp.int32)[None, :] < valid, 0.0, NEG_INF
    )[:, None, None, :].astype(jnp.float32)
    t_max = b.max_target_positions
    layers = []
    for li, p in enumerate(params["decoder"]["blocks"]):
        layers.append({
            "cross_k": state["cross_k"][li][None],
            "cross_v": state["cross_v"][li][None],
            "self_k": jnp.zeros((1, t_max, b.dec_heads, b.head_dim)),
            "self_v": jnp.zeros((1, t_max, b.dec_heads, b.head_dim)),
        })
    dstate = {"layers": tuple(layers)}

    dec = params["decoder"]
    pos_table = jnp.asarray(_abs_pos_table(t_max, b.d_model))

    def dec_pass(dstate, tokens, pos):
        s = tokens.shape[1]
        x = dec["embed"][tokens] * (b.d_model ** 0.5)
        x = x + jax.lax.dynamic_slice(pos_table, (pos, 0), (s, b.d_model))[None]
        new_layers = []
        for p, lst in zip(dec["blocks"], dstate["layers"]):
            # cross q/o use the block's own projections; k/v come from buffers.
            x, nk, nv = decoder_block(
                x, p, b.dec_heads, lst["self_k"], lst["self_v"], pos,
                lst["cross_k"], lst["cross_v"], cross_bias=cross_bias,
            )
            new_layers.append({**lst, "self_k": nk, "self_v": nv})
        x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
        return embedding_logits(dec["embed"], x), {"layers": tuple(new_layers)}

    p_len = prompt.shape[1]
    logits, dstate = dec_pass(dstate, prompt, jnp.asarray(0, jnp.int32))
    logits0 = suppress_tokens(logits[:, -1].astype(jnp.float32), decode_cfg.suppress_ids)
    t_total = p_len + decode_cfg.max_new_tokens + 1
    buf = jnp.zeros((1, t_total), jnp.int32)
    buf = jax.lax.dynamic_update_slice(buf, prompt.astype(jnp.int32), (0, 0))
    if rng is None:
        rng = jax.random.PRNGKey(0)
    first, rng = select_token(logits0, buf, jnp.asarray(p_len, jnp.int32), decode_cfg, rng,
                              history_start=p_len)

    def step(dstate, token, pos):
        lg, dstate = dec_pass(dstate, token, pos)
        return lg[:, -1], dstate

    return ar_decode(step, dstate, jnp.asarray(p_len, jnp.int32), first, buf, decode_cfg, rng)


def collapse_stream_ctc(all_ids: list, blank_id: int = 0) -> list[int]:
    """Collapse concatenated per-chunk CTC argmax ids (host-side)."""
    out: list[int] = []
    prev = -1
    for ids in all_ids:
        for t in ids:
            t = int(t)
            if t != prev and t != blank_id:
                out.append(t)
            prev = t
    return out
