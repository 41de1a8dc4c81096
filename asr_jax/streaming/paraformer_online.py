"""Paraformer streaming: chunked SANM encoder + incremental CIF + decoder.

Capability parity with reference
``Paraformer/Streaming/Export_Paraformer_Streaming.py`` +
``Inference_Paraformer_Streaming_ONNX.py`` (1,510 LoC). Per fixed 8,000-
sample (0.5 s) chunk:

- Kaldi fbank + chunk-local LFR (indices clamped both ends), CMVN, absolute
  position encoding at the running ``start_idx``;
- half-chunk feature overlap carried (``look_back_C`` LFR positions);
- per-layer attention K/V **rolling caches** (keep window
  ``look_back_encoder * B + C`` minus the trailing overlap) — the
  reference's dynamic concat-grow caches become fixed-size ring slices
  with validity masks;
- incremental CIF as a ``lax.scan`` reproducing the reference's exact
  per-step recurrence (carry = partial weighted frame + running alpha),
  firing at integer crossings over the first ``B`` positions;
- decoder (run only when frames fired): FFN -> **causal** FSMN with
  carried history -> cross-attention over [cached | current] encoder
  frames with its own rolling K/V caches.

All state is a pytree of fixed shapes carried across chunk steps; each
step is one jit (state stays device-resident like the reference keeps
OrtValues device-resident, SURVEY.md §3.5).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from asr_jax.frontend.kaldi_fbank import log_mel_fbank
from asr_jax.frontend.lfr import apply_cmvn_addmul
from asr_jax.layers.attention import NEG_INF
from asr_jax.layers.transformer import dense
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import depthwise_conv1d_time
from asr_jax.models.paraformer import ParaformerConfig, _ffn_sanm_decoder
from asr_jax.models.sensevoice import sinusoid_position_encoding


@dataclasses.dataclass(frozen=True)
class ParaformerStreamConfig:
    base: ParaformerConfig = ParaformerConfig()
    chunk_samples: int = 8000
    look_back_encoder: int = 4
    look_back_decoder: int = 1
    look_back_a: int = 0
    max_positions: int = 502          # absolute PE table length (~30 s)
    tail_threshold: float = 0.45      # used by the session at stream end

    @property
    def stft_len(self) -> int:
        fb = self.base.fbank
        return (self.chunk_samples - fb.win_length) // fb.hop_length + 1  # 48

    @property
    def t_lfr(self) -> int:
        m_factor = (self.base.lfr_m - 1) // 2
        return (m_factor + self.stft_len) // self.base.lfr_n + 1  # 9 = look_back_B

    @property
    def look_back_b(self) -> int:
        return self.t_lfr

    @property
    def look_back_c(self) -> int:
        return self.look_back_b // 2  # 4

    @property
    def carry_feats(self) -> int:
        return self.look_back_a + self.look_back_c  # 4

    @property
    def chunk_positions(self) -> int:
        return self.carry_feats + self.t_lfr  # 13

    @property
    def enc_cache_len(self) -> int:
        # Keep slice [-(4B+C):-C] of the concatenated keys -> 4B positions (36).
        return self.look_back_encoder * self.look_back_b

    @property
    def dec_cache_len(self) -> int:
        return self.look_back_decoder * self.look_back_b  # 9

    @property
    def max_fires(self) -> int:
        return self.look_back_b + 1  # initial boundary step + B alpha steps


def init_state(cfg: ParaformerStreamConfig, params: dict, dtype=jnp.float32) -> dict:
    b = cfg.base
    n_layers = b.num_encoders0 + b.num_encoders
    h, hd, d = b.num_heads, b.head_dim, b.hidden
    return {
        "enc_k": jnp.zeros((n_layers, cfg.enc_cache_len, h, hd), dtype),
        "enc_v": jnp.zeros((n_layers, cfg.enc_cache_len, h, hd), dtype),
        "enc_valid": jnp.asarray(0, jnp.int32),
        "prev_feats": jnp.zeros((1, cfg.carry_feats, b.feature_size), dtype),
        "cif_hidden": jnp.zeros((1, 1, d), dtype),   # running weighted average
        "cif_alpha": jnp.zeros((1,), dtype),
        "start_idx": jnp.asarray(0, jnp.int32),
        "dec_fsmn": jnp.zeros((b.num_decoders, b.fsmn_kernel - 1, d), dtype),
        "dec_k": jnp.zeros((b.num_decoders, cfg.dec_cache_len, h, hd), dtype),
        "dec_v": jnp.zeros((b.num_decoders, cfg.dec_cache_len, h, hd), dtype),
        "dec_valid": jnp.asarray(0, jnp.int32),
    }


def _chunk_lfr(cfg: ParaformerStreamConfig, mel: jnp.ndarray) -> jnp.ndarray:
    """Chunk-local LFR with both-end clamping (reference ``:344-347``)."""
    b = cfg.base
    import numpy as np

    base_idx = np.arange(0, cfg.t_lfr * b.lfr_n, b.lfr_n, dtype=np.int32)[:, None]
    offs = np.arange(b.lfr_m, dtype=np.int32)[None, :] - (b.lfr_m - 1) // 2
    idx = np.clip(base_idx + offs, 0, cfg.stft_len - 1).reshape(-1)
    out = jnp.take(mel, jnp.asarray(idx), axis=1)
    return out.reshape(mel.shape[0], cfg.t_lfr, b.feature_size)


def _cif_chunk_scan(
    alphas: jnp.ndarray, hidden: jnp.ndarray, cif_avg: jnp.ndarray, cif_alpha: jnp.ndarray
):
    """Incremental CIF over one chunk, faithful to the reference recurrence
    (``Export_Paraformer_Streaming.py:438-462``).

    Args:
      alphas: (B_steps,) chunk alphas (first look_back_b positions).
      hidden: (B_steps, D) matching encoder states.
      cif_avg: (1, 1, D) carried weighted average; cif_alpha: (1,).

    Returns (frames (1 + B_steps, D), fire flags, new avg (1,1,D), new alpha (1,)).
    """
    d = hidden.shape[-1]
    a0 = cif_alpha[0]
    # Initial boundary step: fire immediately if carried alpha >= 1.
    fire0 = a0 >= 1.0
    avg0 = cif_avg[0, 0]
    frames0 = jnp.where(fire0, avg0, a0 * avg0)
    a1 = jnp.where(fire0, a0 - 1.0, a0)
    f1 = jnp.where(fire0, a1 * avg0, frames0)

    def body(carry, inp):
        f, a = carry
        alpha, h = inp
        threshold = 1.0 - a
        fire = alpha >= threshold
        frame_out = jnp.where(fire, f + threshold * h, f + alpha * h)
        a = a + alpha
        a = jnp.where(fire, a - 1.0, a)
        f = jnp.where(fire, a * h, frame_out)
        return (f, a), (frame_out, fire)

    (f_end, a_end), (frames, fires) = jax.lax.scan(body, (f1, a1), (alphas, hidden))
    all_frames = jnp.concatenate([frames0[None], frames], axis=0)
    all_fires = jnp.concatenate([jnp.asarray([fire0]), fires], axis=0)
    new_avg = (f_end / jnp.maximum(a_end, 1e-9))[None, None]
    return all_frames, all_fires, new_avg, a_end[None]


@functools.partial(jax.jit, static_argnames=("cfg",))
def encoder_step(params: dict, cfg: ParaformerStreamConfig, state: dict, audio_chunk: jnp.ndarray):
    """One 0.5 s chunk -> (state', fired_frames (1, max_fires, D),
    fire_count, encoder_out (1, P, D))."""
    b = cfg.base
    fb = b.fbank
    mel = log_mel_fbank(audio_chunk, fb, cfg.stft_len)
    feats = _chunk_lfr(cfg, mel)
    feats = apply_cmvn_addmul(feats, params["cmvn_means"], params["cmvn_istd"])
    pe = jnp.asarray(sinusoid_position_encoding(cfg.max_positions, b.feature_size))
    pos = jax.lax.dynamic_slice(pe, (state["start_idx"], 0), (cfg.t_lfr, b.feature_size))
    feats = feats + pos[None]
    x = jnp.concatenate([state["prev_feats"], feats], axis=1)  # (1, P, F)
    new_prev = x[:, -cfg.carry_feats :]

    p_cur = cfg.chunk_positions
    cache_len = cfg.enc_cache_len
    layers = params["encoders0"] + params["encoders"]
    new_k = []
    new_v = []
    enc_valid = state["enc_valid"]
    # Keys = [cache | current]; first (cache_len - valid) cache slots masked.
    kpos = jnp.arange(cache_len + p_cur, dtype=jnp.int32)[None, :]
    key_bias = jnp.where(kpos >= cache_len - enc_valid, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)

    for li, p in enumerate(layers):
        y = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"])
        qkv = dense(y, p["qkv"])
        q, k, v = jnp.split(qkv, 3, axis=-1)
        qh = q.reshape(1, p_cur, b.num_heads, b.head_dim)
        kh = k.reshape(1, p_cur, b.num_heads, b.head_dim)
        vh = v.reshape(1, p_cur, b.num_heads, b.head_dim)
        k_full = jnp.concatenate([state["enc_k"][li][None], kh], axis=1)
        v_full = jnp.concatenate([state["enc_v"][li][None], vh], axis=1)
        # New cache: slice [-(4B+C) : -C] of the concatenation.
        start = cache_len + p_cur - (cache_len + cfg.look_back_c)
        new_k.append(jax.lax.dynamic_slice_in_dim(k_full[0], start, cache_len, axis=0))
        new_v.append(jax.lax.dynamic_slice_in_dim(v_full[0], start, cache_len, axis=0))
        scores = jnp.einsum("bqhd,bkhd->bhqk", qh, k_full).astype(jnp.float32) * (b.head_dim ** -0.5)
        probs = jax.nn.softmax(scores + key_bias, axis=-1).astype(x.dtype)
        ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, v_full).reshape(1, p_cur, b.hidden)
        pad = (b.fsmn_kernel - 1) // 2
        mem = depthwise_conv1d_time(v, p["fsmn_w"], pad, pad) + v
        branch = dense(ctx, p["out"]) + mem
        x = branch + x if li > 0 else branch
        y2 = layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"])
        # dense() rewrap (not raw jnp.dot): ffn w1/w2 may be quantized
        # leaves — the quant route dispatches them (same as sanm_block)
        h = jnp.maximum(dense(y2, {"w": p["ffn"]["w1"], "b": p["ffn"]["b1"]}), 0)
        x = x + dense(h, {"w": p["ffn"]["w2"], "b": p["ffn"]["b2"]})

    encoder_out = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])

    # CIF alphas over the chunk.
    pp = params["predictor"]
    padc = (b.predictor_kernel - 1) // 2
    conv = jax.lax.conv_general_dilated(
        encoder_out, pp["conv"]["w"], (1,), [(padc, padc)], dimension_numbers=("NHC", "HIO", "NHC")
    ) + pp["conv"]["b"]
    # dense(): the predictor head may be a quantized leaf (offline
    # predict_alphas routes it the same way)
    alphas = jax.nn.sigmoid(dense(jnp.maximum(conv, 0), pp["out"]))[0, :, 0]

    a_lo = cfg.look_back_a
    frames, fires, new_avg, new_alpha = _cif_chunk_scan(
        alphas[a_lo : a_lo + cfg.look_back_b],
        encoder_out[0, a_lo : a_lo + cfg.look_back_b],
        state["cif_hidden"],
        state["cif_alpha"],
    )
    # Compact fired frames into (max_fires, D).
    mf = cfg.max_fires
    dest = jnp.cumsum(fires.astype(jnp.int32)) - 1
    dest = jnp.where(fires, dest, mf)
    buf = jnp.zeros((mf + 1, frames.shape[-1]), frames.dtype).at[dest].set(frames, mode="drop")
    count = jnp.sum(fires).astype(jnp.int32)

    new_state = {
        **state,
        "enc_k": jnp.stack(new_k),
        "enc_v": jnp.stack(new_v),
        "enc_valid": jnp.minimum(enc_valid + cfg.look_back_b, cache_len),
        "prev_feats": new_prev,
        "cif_hidden": new_avg,
        "cif_alpha": new_alpha,
        "start_idx": state["start_idx"] + cfg.t_lfr,
    }
    return new_state, buf[None, :mf], count, encoder_out


@functools.partial(jax.jit, static_argnames=("cfg", "return_logits"))
def decoder_step(
    params: dict,
    cfg: ParaformerStreamConfig,
    state: dict,
    encoder_out: jnp.ndarray,
    fired: jnp.ndarray,
    count: jnp.ndarray,
    return_logits: bool = False,
):
    """Decode fired CIF frames -> (state', token ids (1, max_fires), count).

    Run only when ``count > 0`` (the reference skips the decoder session
    otherwise, keeping its caches untouched). ``return_logits=True``
    returns (state', logits (1, max_fires, V), count) instead — the stage
    probes snapshot the pre-argmax decoder output."""
    b = cfg.base
    n = fired.shape[1]
    tok_mask = jnp.arange(n, dtype=jnp.int32)[None, :] < count
    x = jnp.where(tok_mask[..., None], fired, 0)
    p_enc = encoder_out.shape[1]
    cache_len = cfg.dec_cache_len
    kpos = jnp.arange(cache_len + p_enc, dtype=jnp.int32)[None, :]
    key_bias = jnp.where(kpos >= cache_len - state["dec_valid"], 0.0, NEG_INF)[
        :, None, None, :
    ].astype(jnp.float32)
    hist = b.fsmn_kernel - 1

    new_fsmn = []
    new_k = []
    new_v = []
    for li, p in enumerate(params["decoders"]):
        residual = x
        y = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
        sa_in = layer_norm(y, p["norm2"]["scale"], p["norm2"]["bias"])
        sa_in = jnp.where(tok_mask[..., None], sa_in, 0)
        seq = jnp.concatenate([state["dec_fsmn"][li][None], sa_in], axis=1)  # (1, hist+n, D)
        # New history: last `hist` VALID positions of [history | valid frames].
        start = jnp.clip(count + hist - hist, 0, n)  # == count, kept explicit
        new_fsmn.append(jax.lax.dynamic_slice_in_dim(seq[0], start, hist, axis=0))
        mem = depthwise_conv1d_time(seq, p["fsmn_w"], 0, 0)  # causal: kernel eats history
        x = mem + sa_in + residual
        c_in = layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"])
        q = (dense(c_in, p["cross"]["q"])).reshape(
            1, n, b.num_heads, b.head_dim
        )
        kv = dense(encoder_out, p["cross"]["kv"])
        k, v = jnp.split(kv, 2, axis=-1)
        kh = k.reshape(1, p_enc, b.num_heads, b.head_dim)
        vh = v.reshape(1, p_enc, b.num_heads, b.head_dim)
        k_full = jnp.concatenate([state["dec_k"][li][None], kh], axis=1)
        v_full = jnp.concatenate([state["dec_v"][li][None], vh], axis=1)
        new_k.append(k_full[0, -cache_len:])
        new_v.append(v_full[0, -cache_len:])
        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k_full).astype(jnp.float32) * (b.head_dim ** -0.5)
        probs = jax.nn.softmax(scores + key_bias, axis=-1).astype(x.dtype)
        ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, v_full).reshape(1, n, b.hidden)
        x = x + dense(ctx, p["cross"]["out"])

    for p in params["decoder_ffn"]:
        x = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
    x = layer_norm(x, params["decoder_after_norm"]["scale"], params["decoder_after_norm"]["bias"])
    logits = dense(x, params["output"])
    ids = jnp.where(tok_mask, jnp.argmax(logits, axis=-1).astype(jnp.int32), 0)

    new_state = {
        **state,
        "dec_fsmn": jnp.stack(new_fsmn),
        "dec_k": jnp.stack(new_k),
        "dec_v": jnp.stack(new_v),
        "dec_valid": jnp.minimum(state["dec_valid"] + p_enc, cache_len),
    }
    return new_state, (logits if return_logits else ids), count
