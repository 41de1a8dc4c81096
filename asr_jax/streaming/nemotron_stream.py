"""Nemotron cache-aware streaming: chunked FastConformer + continuous RNN-T.

Capability parity with reference ``Nemotron/Export_Nemotron_ASR.py``
``NemotronStreamingEncoder`` (:697-830) + the streaming driver
(``Inference_Nemotron_ASR_ONNX.py:300-380``). Per fixed audio window
(``chunk = right_context + 1`` output frames):

- snip-edges mel over the window (1 leading sample seeds pre-emphasis),
  with a ``pre_encode_cache`` mel-frame carry;
- causal pre-encode producing exactly ``chunk + drop_extra`` frames;
- per-layer **cache_last_channel** (post-norm attention input, left
  context) and **cache_last_time** (depthwise-conv tail) carries, with a
  startup mask indexed by ``cache_len``;
- relative attention computed against the fixed
  ``left_context + chunk``-key window via a gathered rel-shift;
- RNN-T greedy continues across chunks with carried predictor state.

Bit-compatible with the offline graph frame-for-frame (that is the
reference's design goal) — verified in tests by comparing streamed
encoder frames against the offline chunked-mask encoder.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.layers.norms import layer_norm
from asr_jax.layers.transformer import dense
from asr_jax.models.nemotron import NemotronConfig, joint_step


@dataclasses.dataclass(frozen=True)
class NemotronStreamConfig:
    base: NemotronConfig = NemotronConfig()

    @property
    def chunk(self) -> int:                  # encoder frames per step
        return self.base.right_context + 1

    @property
    def mel_chunk(self) -> int:              # new mel frames per step
        return self.chunk * 8

    @property
    def mel_cache(self) -> int:
        return self.base.pre_encode_cache

    @property
    def window_samples(self) -> int:         # audio samples per step
        m = self.base.mel
        return m.n_fft + (self.mel_chunk - 1) * m.hop_length + 1

    @property
    def kv_len(self) -> int:
        return self.base.left_context + self.chunk


def init_state(cfg: NemotronStreamConfig, dtype=jnp.float32) -> dict:
    b = cfg.base
    return {
        # Zero-filled like the reference driver (filled_for default 0) — this
        # is what makes the first chunk bit-match the offline zero padding.
        "mel_cache": jnp.zeros((1, cfg.mel_cache, b.mel.n_mels), dtype),
        "cache_last_channel": jnp.zeros((b.num_layers, cfg.kv_len - cfg.chunk, b.d_model), dtype),
        "cache_last_time": jnp.zeros((b.num_layers, b.conv_kernel - 1, b.d_model), dtype),
        "cache_len": jnp.asarray(0, jnp.int32),
        # RNN-T continuation state.
        "token": jnp.asarray([0], jnp.int32),  # session sets to blank_id
        "h": jnp.zeros((b.lstm_layers, 1, b.pred_hidden), dtype),
        "c": jnp.zeros((b.lstm_layers, 1, b.pred_hidden), dtype),
        "nsym": jnp.asarray(0, jnp.int32),
    }


def _stream_mel(cfg: NemotronStreamConfig, audio: jnp.ndarray) -> jnp.ndarray:
    """Snip-edges mel: (1, window_samples) -> (1, mel_chunk, n_mels)."""
    from asr_jax.frontend.nemo_mel import _nemo_constants
    from asr_jax.frontend import framing

    m = cfg.base.mel
    basis_np, mel_np = _nemo_constants(m)
    basis, mel = jnp.asarray(basis_np), jnp.asarray(mel_np)
    x = audio.astype(jnp.float32) * m.input_scale
    x = x[:, 1:] - m.preemphasis * x[:, :-1]
    frames = framing.frame_signal(x, m.n_fft, m.hop_length, cfg.mel_chunk)
    spec = jnp.dot(frames, basis, precision=jax.lax.Precision.HIGHEST)
    re, im = jnp.split(spec * spec, 2, axis=-1)
    melspec = jnp.dot(re + im, mel, precision=jax.lax.Precision.HIGHEST)
    return jnp.log(jnp.maximum(melspec, m.log_guard))


@functools.lru_cache(maxsize=8)
def _stream_rel_index(chunk: int, kv_len: int) -> np.ndarray:
    """Gathered rel-shift index (reference ``:728-733``): query i / key j
    reads pos-table column (chunk - 1 - i) + j of the 2*kv_len-1 table."""
    i = np.arange(chunk, dtype=np.int32)[:, None]
    j = np.arange(kv_len, dtype=np.int32)[None, :]
    # Table row p of the (2*kv_len-1)-wide PE covers relative distance
    # kv_len-1-p; row (chunk-1-i)+j therefore reads rel = left + i - j.
    return (chunk - 1 - i) + j


def precompute_rel_k(params: dict, cfg: NemotronStreamConfig) -> jnp.ndarray:
    """Per-layer projected relative-position keys, shape
    ``(num_layers, 2*kv_len-1, num_heads, head_dim)``.

    ``pe @ rel_k`` is a params-only constant; the per-chunk step was
    re-projecting the full (2*kv_len-1)-row sinusoid table through all 24
    layers' ``rel_k`` weights every tick (24 × 167 × 1024² ≈ 8.4 GFLOP per
    chunk, ≈27% of the step at default geometry). Sessions compute this
    once and pass it to ``encoder_step``; ``None`` keeps the in-graph path."""
    from asr_jax.layers.conformer import relative_position_embedding

    b = cfg.base
    hd = b.d_model // b.num_heads
    pe = jnp.asarray(relative_position_embedding(cfg.kv_len, b.d_model))
    return jnp.stack([
        dense(pe, bp["attn"]["rel_k"]).reshape(-1, b.num_heads, hd)
        for bp in params["blocks"]])


@functools.partial(jax.jit, static_argnames=("cfg",))
def encoder_step(params: dict, cfg: NemotronStreamConfig, state: dict, audio: jnp.ndarray, prompt_id: jnp.ndarray,
                 rel_k_cache: jnp.ndarray | None = None):
    """One audio window -> (state', enc_proj (1, chunk, joint_hidden))."""
    mel_new = _stream_mel(cfg, audio)
    return encoder_step_features(params, cfg, state, mel_new, prompt_id, rel_k_cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def encoder_step_features(
    params: dict, cfg: NemotronStreamConfig, state: dict, mel_new: jnp.ndarray, prompt_id: jnp.ndarray,
    rel_k_cache: jnp.ndarray | None = None,
):
    """One mel chunk (1, mel_chunk, n_mels) -> (state', enc_proj)."""
    from asr_jax.layers.conformer import relative_position_embedding

    b = cfg.base
    mel_full = jnp.concatenate([state["mel_cache"], mel_new], axis=1)
    mel_cache_next = mel_full[:, -cfg.mel_cache :]

    # Causal pre-encode; reference uses pad_top = 2 for the streaming path
    # (the mel cache supplies the left context the offline pad emulates).
    p = params["pre_encode"]
    ch = p["conv0"]["w"].shape[-1]
    from asr_jax.models.nemotron import _causal_conv2d

    x = mel_full[..., None]
    x = jax.nn.relu(_causal_conv2d(x, p["conv0"]["w"], p["conv0"]["b"], 1, 2))
    x = _causal_conv2d(x, p["dw1"]["w"], p["dw1"]["b"], ch)
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, p["pw1"]["w"], (1, 1), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["pw1"]["b"])
    x = _causal_conv2d(x, p["dw2"]["w"], p["dw2"]["b"], ch)
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, p["pw2"]["w"], (1, 1), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["pw2"]["b"])
    t = x.shape[1]
    x = x.transpose(0, 1, 3, 2).reshape(1, t, -1)
    x = dense(x, p["out"])
    x = x[0, -(cfg.chunk) :]  # exactly `chunk` frames (1-chunk step latency)

    kv_len = cfg.kv_len
    left = kv_len - cfg.chunk
    # Startup mask: keys j valid when j >= left - cache_len.
    j = jnp.arange(kv_len, dtype=jnp.int32)[None, :]
    neg = jnp.where(j >= left - state["cache_len"], 0.0, -128.0).astype(jnp.float32)
    pe = jnp.asarray(relative_position_embedding(kv_len, b.d_model))
    rel_idx = jnp.asarray(_stream_rel_index(cfg.chunk, kv_len))

    hd = b.d_model // b.num_heads
    channel_next = []
    time_next = []
    for li, bp in enumerate(params["blocks"]):
        residual = x
        m = layer_norm(x, bp["norm_ff1"]["scale"], bp["norm_ff1"]["bias"])
        residual = residual + 0.5 * dense(jax.nn.silu(dense(m, bp["ff1"]["w1"])), bp["ff1"]["w2"])

        m = layer_norm(residual, bp["norm_att"]["scale"], bp["norm_att"]["bias"])
        m_full = jnp.concatenate([state["cache_last_channel"][li], m], axis=0)  # (kv_len, D)
        channel_next.append(m_full[-left:])
        q = dense(m, bp["attn"]["q"]).reshape(cfg.chunk, b.num_heads, hd).transpose(1, 0, 2)
        k = dense(m_full, bp["attn"]["k"]).reshape(kv_len, b.num_heads, hd).transpose(1, 0, 2)
        v = dense(m_full, bp["attn"]["v"]).reshape(kv_len, b.num_heads, hd).transpose(1, 0, 2)
        rel_k = (rel_k_cache[li] if rel_k_cache is not None else
                 dense(pe, bp["attn"]["rel_k"]).reshape(-1, b.num_heads, hd))
        qu = q + bp["attn"]["bias_u"][:, None, :]
        qv = q + bp["attn"]["bias_v"][:, None, :]
        ac = jnp.einsum("hqd,hkd->hqk", qu, k)
        bd_full = jnp.einsum("hqd,phd->hqp", qv, rel_k)  # (H, Q, 2*kv_len-1)
        bd = jnp.take_along_axis(bd_full, rel_idx[None], axis=2)
        scores = (ac + bd).astype(jnp.float32) * (hd ** -0.5) + neg[None]
        probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
        ctx = jnp.einsum("hqk,hkd->qhd", probs, v).reshape(cfg.chunk, b.d_model)
        residual = residual + dense(ctx, bp["attn"]["o"])

        m = layer_norm(residual, bp["norm_conv"]["scale"], bp["norm_conv"]["bias"])
        y = dense(m, bp["conv"]["pw1"])
        a, g = jnp.split(y, 2, axis=-1)
        y = a * jax.nn.sigmoid(g)
        dw_in = jnp.concatenate([state["cache_last_time"][li], y], axis=0)  # (K-1+chunk, D)
        time_next.append(dw_in[-(b.conv_kernel - 1) :])
        kk = b.conv_kernel
        out = dw_in[None, 0 : cfg.chunk] * bp["conv"]["dw"]["w"][0]
        for tap in range(1, kk):
            out = out + dw_in[None, tap : tap + cfg.chunk] * bp["conv"]["dw"]["w"][tap]
        y = layer_norm(out[0], bp["conv"]["ln"]["scale"], bp["conv"]["ln"]["bias"])
        y = jax.nn.silu(y)
        residual = residual + dense(y, bp["conv"]["pw2"])

        m = layer_norm(residual, bp["norm_ff2"]["scale"], bp["norm_ff2"]["bias"])
        residual = residual + 0.5 * dense(jax.nn.silu(dense(m, bp["ff2"]["w1"])), bp["ff2"]["w2"])
        x = layer_norm(residual, bp["norm_out"]["scale"], bp["norm_out"]["bias"])

    pr = params["prompt"]
    h0 = jax.nn.relu(jnp.dot(x, pr["w0_enc"]) + pr["bias_table"][prompt_id][0])
    enc_proj = dense(dense(h0, pr["w2"]), pr["joint_enc"])[None]

    new_state = {
        **state,
        "mel_cache": mel_cache_next,
        "cache_last_channel": jnp.stack(channel_next),
        "cache_last_time": jnp.stack(time_next),
        "cache_len": jnp.minimum(state["cache_len"] + cfg.chunk, left),
    }
    return new_state, enc_proj


@functools.partial(jax.jit, static_argnames=("cfg", "max_new"))
def rnnt_stream_step(params: dict, cfg: NemotronStreamConfig, state: dict, enc_proj: jnp.ndarray, max_new: int = 32):
    """Continue RNN-T greedy over this chunk's frames with carried
    predictor state; returns (state', ids (1, max_new), count)."""
    b = cfg.base
    t = enc_proj.shape[1]
    max_steps = (b.max_symbols_per_frame + 1) * t

    init = (
        jnp.asarray(0, jnp.int32),          # frame
        state["nsym"],
        state["token"],
        state["h"],
        state["c"],
        jnp.zeros((max_new + 1,), jnp.int32),
        jnp.asarray(0, jnp.int32),          # count
        jnp.asarray(0, jnp.int32),          # steps
    )

    def cond(carry):
        frame, nsym, token, h, c, buf, count, steps = carry
        return (frame < t) & (steps < max_steps) & (count < max_new)

    def body(carry):
        frame, nsym, token, h, c, buf, count, steps = carry
        enc_frame = jax.lax.dynamic_slice_in_dim(enc_proj[0], frame, 1, axis=0)
        logits, h2, c2 = joint_step(params, token, h, c, enc_frame)
        tok = jnp.argmax(logits[0], axis=-1).astype(jnp.int32)
        is_blank = tok == b.blank_id
        emit = (~is_blank) & (nsym < b.max_symbols_per_frame)
        buf = buf.at[jnp.where(emit, count, max_new)].set(tok, mode="drop")
        count = count + emit.astype(jnp.int32)
        token = jnp.where(emit, tok[None], token)
        h = jnp.where(emit, h2, h)
        c = jnp.where(emit, c2, c)
        advance = is_blank | (nsym >= b.max_symbols_per_frame)
        frame = frame + advance.astype(jnp.int32)
        nsym = jnp.where(advance, 0, nsym + emit.astype(jnp.int32))
        return (frame, nsym, token, h, c, buf, count, steps + 1)

    frame, nsym, token, h, c, buf, count, _ = jax.lax.while_loop(cond, body, init)
    new_state = {**state, "token": token, "h": h, "c": c, "nsym": nsym}
    return new_state, buf[None, :max_new], count
