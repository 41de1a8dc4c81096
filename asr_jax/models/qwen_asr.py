"""Qwen3-ASR: chunk-windowed audio tower + Qwen3 LLM decoder.

Capability parity with reference ``Qwen_ASR/Export_Qwen_ASR.py`` +
``Inference_Qwen_ASR_ONNX.py`` (7,305 LoC): Whisper-mel front-end, audio
tower that convs each 100-frame mel chunk to 13 tokens (3x stride-2
conv2d), windowed self-attention over 8-chunk (104-token) windows with
per-window valid-count key masks, projection into the LLM embedding space,
prompt assembly [head | context(query) | suffix | audio | tail], and the
Qwen3 decoder (GQA + RoPE + per-head q/k RMSNorm) with greedy /
penalty-greedy / top-k-top-p decode via the shared AR loop.

Static shapes: the reference's dynamic-length ONNX axes become a static
prompt buffer with a **gather-compacted** embed sequence (audio's valid
prefix is packed against the tail; padded slots are masked and then
overwritten by generated tokens), so the whole pipeline jits once.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig, ar_decode, select_token
from asr_jax.decode.strategies import suppress_tokens
from asr_jax.frontend.whisper_mel import WhisperMelConfig, log_mel_spectrogram
from asr_jax.layers import qwen3
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.transformer import dense, merge_heads, mha, split_heads
from asr_jax.models.sensevoice import sinusoid_position_encoding


@dataclasses.dataclass(frozen=True)
class QwenAsrConfig:
    # Audio tower (Qwen3-ASR-0.6B geometry).
    n_mels: int = 128
    tower_dim: int = 1280
    tower_layers: int = 32
    tower_heads: int = 20
    tower_ffn: int = 5120
    downsample_hidden: int = 480
    chunk_frames: int = 100          # mel frames per conv chunk
    tokens_per_chunk: int = 13
    chunks_per_window: int = 8
    output_dim: int = 1024           # LLM hidden
    llm: qwen3.Qwen3Config = qwen3.Qwen3Config()
    eot_id: int = 151645             # <|im_end|>
    sample_rate: int = 16000

    @property
    def tokens_per_window(self) -> int:
        return self.chunks_per_window * self.tokens_per_chunk

    def mel_config(self) -> WhisperMelConfig:
        return WhisperMelConfig(n_mels=self.n_mels, sample_rate=self.sample_rate)


def feat_output_len(frames: jnp.ndarray, chunk: int = 100) -> jnp.ndarray:
    """Audio-token count for ``frames`` mel frames (reference
    ``_get_feat_extract_output_lengths``, ``Export_Qwen_ASR.py:518-526``)."""
    leave = frames % chunk
    f1 = jnp.maximum(leave - 1, 0) // 2 + 1
    f1 = f1 * (leave > 0)
    f2 = jnp.maximum(f1 - 1, 0) // 2 + 1
    f2 = f2 * (f1 > 0)
    f3 = jnp.maximum(f2 - 1, 0) // 2 + 1
    f3 = f3 * (f2 > 0)
    return f3 + (frames // chunk) * 13


def init_tower_params(cfg: QwenAsrConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 4096))
    d, c = cfg.tower_dim, cfg.downsample_hidden

    def lin(i, o, bias=True):
        p = {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def norm(dd=d):
        return {"scale": jnp.ones((dd,), dtype), "bias": jnp.zeros((dd,), dtype)}

    def block():
        return {
            "ln1": norm(),
            "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)},
            "ln2": norm(),
            "mlp": {"fc1": lin(d, cfg.tower_ffn), "fc2": lin(cfg.tower_ffn, d)},
        }

    freq_out = cfg.n_mels
    for _ in range(3):
        freq_out = (freq_out + 1) // 2
    return {
        "conv1": {"w": (jax.random.normal(next(keys), (3, 3, 1, c)) * 0.05).astype(dtype), "b": jnp.zeros((c,), dtype)},
        "conv2": {"w": (jax.random.normal(next(keys), (3, 3, c, c)) * 0.05).astype(dtype), "b": jnp.zeros((c,), dtype)},
        "conv3": {"w": (jax.random.normal(next(keys), (3, 3, c, c)) * 0.05).astype(dtype), "b": jnp.zeros((c,), dtype)},
        "conv_out": lin(c * freq_out, d, bias=False),
        "blocks": [block() for _ in range(cfg.tower_layers)],
        "ln_post": norm(),
        "proj1": lin(d, d),
        "proj2": lin(d, cfg.output_dim),
    }


def _conv2d_s2(x, p):
    y = jax.lax.conv_general_dilated(
        x, p["w"], (2, 2), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC")
    )
    return y + p["b"]


def encode_audio(
    tower: dict, cfg: QwenAsrConfig, mel: jnp.ndarray, valid_frames: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """mel (B, T, n_mels) -> (audio tokens (B, A_max, output_dim), valid (B,)).

    T must be a multiple of chunk_frames * chunks_per_window (pad with
    zeros); invalid mel frames are zero-masked.  Batched: the window axis
    already rides the conv/attention batch dim, so B utterances simply
    become B x num_windows independent windows (the reference is strictly
    batch-1, ``Inference_Qwen_ASR_ONNX.py``).
    """
    b, t = mel.shape[0], mel.shape[1]
    chunk = cfg.chunk_frames
    num_chunks = t // chunk
    keep = jnp.arange(t, dtype=jnp.int32)[None, :] < valid_frames[:, None]
    mel = jnp.where(keep[..., None], mel, 0.0)

    # (B, T, M) -> chunks (B*num_chunks, M, chunk) -> NHWC (N, M, chunk, 1)
    x = mel.reshape(b * num_chunks, chunk, cfg.n_mels).transpose(0, 2, 1)[..., None]
    x = jax.nn.gelu(_conv2d_s2(x, tower["conv1"]), approximate=False)
    x = jax.nn.gelu(_conv2d_s2(x, tower["conv2"]), approximate=False)
    x = jax.nn.gelu(_conv2d_s2(x, tower["conv3"]), approximate=False)  # (N, 16, 13, C)
    n, f, tt, c = x.shape
    x = x.transpose(0, 2, 3, 1).reshape(n, tt, c * f)  # channel-major (C, mel)
    x = dense(x, tower["conv_out"])  # (N, 13, d)
    pe = jnp.asarray(sinusoid_position_encoding(cfg.tokens_per_chunk, cfg.tower_dim, start=0))
    x = x + pe[None]

    # Per-chunk valid token counts, per sample.
    chunk_starts = jnp.arange(num_chunks, dtype=jnp.int32) * chunk
    raw_lens = jnp.clip(valid_frames[:, None] - chunk_starts[None, :], 0, chunk)
    aftercnn = feat_output_len(raw_lens.astype(jnp.int32), chunk)  # (B, num_chunks)
    # Window packing: (B*num_windows, tokens_per_window, d)
    cpw = cfg.chunks_per_window
    num_windows = num_chunks // cpw
    tw = cfg.tokens_per_window
    hidden = x.reshape(b * num_windows, tw, cfg.tower_dim)
    valid_counts = aftercnn.reshape(b * num_windows, cpw).sum(axis=1)
    kpos = jnp.arange(tw, dtype=jnp.int32)[None, :]
    bias = jnp.where(kpos < valid_counts[:, None], 0.0, -128.0)[:, None, None, :].astype(jnp.float32)

    h = hidden
    for p in tower["blocks"]:
        y = layer_norm(h, p["ln1"]["scale"], p["ln1"]["bias"])
        q = split_heads(dense(y, p["attn"]["q"]), cfg.tower_heads)
        k = split_heads(dense(y, p["attn"]["k"]), cfg.tower_heads)
        v = split_heads(dense(y, p["attn"]["v"]), cfg.tower_heads)
        h = h + dense(merge_heads(mha(q, k, v, bias=bias)), p["attn"]["o"])
        y = layer_norm(h, p["ln2"]["scale"], p["ln2"]["bias"])
        h = h + dense(jax.nn.gelu(dense(y, p["mlp"]["fc1"]), approximate=False), p["mlp"]["fc2"])
    h = layer_norm(h, tower["ln_post"]["scale"], tower["ln_post"]["bias"])
    h = dense(jax.nn.gelu(dense(h, tower["proj1"]), approximate=False), tower["proj2"])
    audio = h.reshape(b, num_windows * tw, cfg.output_dim)
    return audio, jnp.sum(aftercnn, axis=1)


def assemble_prompt(
    head: jnp.ndarray, query: jnp.ndarray, suffix: jnp.ndarray,
    audio: jnp.ndarray, audio_valid: jnp.ndarray, tail: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gather-compact [head|query|suffix|audio_valid|tail] into a static
    buffer with padding at the END. All inputs (B, L_i, H); per-sample
    ``audio_valid`` (B,) compacts each row independently."""
    base = head.shape[1] + query.shape[1] + suffix.shape[1]
    a_max = audio.shape[1]
    full = jnp.concatenate([head, query, suffix, audio, tail], axis=1)
    lf = full.shape[1]
    a = audio_valid[:, None].astype(jnp.int32)               # (B, 1)
    idx = jnp.arange(lf, dtype=jnp.int32)[None, :]           # (1, lf)
    src = jnp.where(idx < base + a, idx, jnp.minimum(idx + (a_max - a), lf - 1))
    embeds = jnp.take_along_axis(full, src[..., None], axis=1)
    valid = base + audio_valid.astype(jnp.int32) + tail.shape[1]
    return embeds, valid


@functools.partial(jax.jit, static_argnames=("cfg", "decode_cfg"))
def transcribe_embeds(
    llm_params: dict,
    cfg: QwenAsrConfig,
    embeds: jnp.ndarray,
    valid_len: jnp.ndarray,
    decode_cfg: DecodeConfig,
    rng: jax.Array | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Prompt embeds (B, L, H) (valid prefix + END padding, as produced by
    :func:`assemble_prompt`) + per-sample valid lengths -> generated ids.

    Internally each row is re-packed LEFT-padded (valid tokens end at slot
    ``L``), so rows of UNEQUAL prompt length decode in lockstep from one
    scalar position: RoPE attention scores depend only on position
    differences, making the per-row shift mathematically equivalent, and
    pad slots are masked out of every attention. Generated ids land at
    slots ``[L, L + counts)`` for every row.

    Returns (tokens (B, L + max_new + 1), counts (B,), prompt_start (B,)
    — always ``L``).
    """
    lcfg = cfg.llm
    b, lf, _ = embeds.shape
    valid_len = valid_len.astype(jnp.int32)
    # Right-compacted -> left-padded: out slot i takes source i - shift.
    shift = lf - valid_len                                     # (B,)
    idx = jnp.arange(lf, dtype=jnp.int32)[None, :]
    src = jnp.clip(idx - shift[:, None], 0, lf - 1)
    embeds = jnp.take_along_axis(embeds, src[..., None], axis=1)

    t_buf = lf + decode_cfg.max_new_tokens + 1
    # The cache rounds up to a multiple of 8, as the continuous batcher's
    # does; the extra slots are always masked.
    t_max = -(-t_buf // 8) * 8
    state = qwen3.make_kv_state(lcfg, b, t_max, embeds.dtype)
    bias = qwen3.left_prefill_bias(shift, lf, t_max)
    hidden, state = qwen3.decoder_pass(
        llm_params, lcfg, embeds, state, jnp.asarray(0, jnp.int32), bias, pos_offset=shift
    )
    # Every row's last valid token sits at slot lf - 1.
    logits0 = qwen3.logits_from_hidden(llm_params, lcfg, hidden[:, -1])
    logits0 = suppress_tokens(logits0.astype(jnp.float32), decode_cfg.suppress_ids)

    buf = jnp.zeros((b, t_buf), jnp.int32)
    prompt_len = jnp.asarray(lf, jnp.int32)
    if rng is None:
        rng = jax.random.PRNGKey(0)
    first, rng = select_token(logits0, buf, prompt_len, decode_cfg, rng,
                              history_start=prompt_len)

    def step(state, token, pos):
        emb = llm_params["embed"][token].astype(embeds.dtype)
        sbias = qwen3.left_step_bias(shift, pos, t_max)
        h, state = qwen3.decoder_pass(llm_params, lcfg, emb, state, pos, sbias,
                                      pos_offset=shift)
        return qwen3.logits_from_hidden(llm_params, lcfg, h[:, -1]), state

    tokens, counts = ar_decode(step, state, prompt_len, first, buf, decode_cfg, rng)
    return tokens, counts, jnp.full((b,), lf, jnp.int32)


def prompt_embeds(
    tower_params: dict,
    llm_params: dict,
    cfg: QwenAsrConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    prompt_ids: dict,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Front half of :func:`forward`: raw audio (B, S) [-1,1] + prompt id
    arrays -> compacted prompt embeds (B, L, H) + valid lengths (B,) in the
    :func:`assemble_prompt` layout (valid prefix, END padding).

    Split out so the continuous-batching server
    (``parallel/llm_server.py``) can prefill one request independently of
    everyone else's decode steps."""
    mel_cfg = cfg.mel_config()
    mel = log_mel_spectrogram(audio, mel_cfg)
    window_frames = cfg.chunk_frames * cfg.chunks_per_window
    t = mel.shape[1]
    pad = (-t) % window_frames
    if pad:
        mel = jnp.pad(mel, ((0, 0), (0, pad), (0, 0)))
    valid_frames = (valid_samples // mel_cfg.hop_length).astype(jnp.int32)
    audio_tokens, audio_valid = encode_audio(tower_params, cfg, mel, valid_frames)

    emb = lambda ids: llm_params["embed"][ids].astype(audio_tokens.dtype)
    return assemble_prompt(
        emb(prompt_ids["head"]), emb(prompt_ids["query"]), emb(prompt_ids["suffix"]),
        audio_tokens, audio_valid, emb(prompt_ids["tail"]),
    )


def forward(
    tower_params: dict,
    llm_params: dict,
    cfg: QwenAsrConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    prompt_ids: dict,
    decode_cfg: DecodeConfig,
    rng: jax.Array | None = None,
):
    """Raw audio (B, S) [-1,1] + prompt id lists -> generated token ids.

    ``prompt_ids``: dict of int32 arrays {"head": (B, Lh), "query": (B, Lq),
    "suffix": (B, Ls), "tail": (B, Lt)} (reference prompt layout
    ``Inference_Qwen_ASR_ONNX.py:106-127``; the reference is batch-1 —
    batching is this framework's addition for throughput serving).
    """
    embeds, valid_len = prompt_embeds(
        tower_params, llm_params, cfg, audio, valid_samples, prompt_ids)
    return transcribe_embeds(llm_params, cfg, embeds, valid_len, decode_cfg, rng)
