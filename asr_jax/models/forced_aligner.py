"""Qwen3 ForcedAligner: NAR timestamp classification.

Capability parity with reference
``Qwen_ForcedAligner/Export_Qwen_ForcedAligner.py`` +
``Inference_Qwen_ForcedAligner_ONNX.py`` (3,066 LoC): the Qwen3-ASR audio
tower + Qwen3 decoder, but the head is a ``classify_num``-bucket timestamp
classifier and the model runs ONE non-autoregressive pass — every
``<timestamp>`` prompt position classifies an 80 ms time bucket; no KV
cache growth, no decode loop. Prompt layout:
[<|audio_start|> | audio embeds | <|audio_end|> | text/timestamp embeds].

Reuses ``asr_jax.layers.qwen3`` and the gather-compacted static prompt
from ``asr_jax.models.qwen_asr``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from asr_jax.layers import qwen3
from asr_jax.layers.norms import rms_norm
from asr_jax.layers.transformer import dense
from asr_jax.models.qwen_asr import QwenAsrConfig, assemble_prompt, encode_audio
from asr_jax.frontend.whisper_mel import log_mel_spectrogram


@dataclasses.dataclass(frozen=True)
class ForcedAlignerConfig:
    asr: QwenAsrConfig = QwenAsrConfig()
    classify_num: int = 375          # 30 s / 80 ms buckets
    segment_ms: int = 80


@functools.partial(jax.jit, static_argnames=("cfg",))
def align_logits(
    llm_params: dict,
    head: dict,
    cfg: ForcedAlignerConfig,
    embeds: jnp.ndarray,
    valid_len: jnp.ndarray,
) -> jnp.ndarray:
    """One NAR pass -> timestamp-head logits (1, L, classify_num). Split
    from :func:`align_embeds` so stage probes snapshot the pre-argmax head."""
    lcfg = cfg.asr.llm
    b, lf, _ = embeds.shape
    state = qwen3.make_kv_state(lcfg, b, lf, embeds.dtype)
    bias = qwen3.causal_prefill_bias(valid_len, lf, lf)
    hidden, _ = qwen3.decoder_pass(llm_params, lcfg, embeds, state, jnp.asarray(0, jnp.int32), bias)
    y = rms_norm(hidden, llm_params["final_norm"]["scale"], lcfg.rms_eps)
    return dense(y, head)  # (1, L, classify_num)


def align_embeds(
    llm_params: dict,
    head: dict,
    cfg: ForcedAlignerConfig,
    embeds: jnp.ndarray,
    valid_len: jnp.ndarray,
) -> jnp.ndarray:
    """One NAR pass -> per-position bucket ids (1, L)."""
    logits = align_logits(llm_params, head, cfg, embeds, valid_len)
    return jnp.argmax(logits, axis=-1).astype(jnp.int32)


def prompt_for(
    tower_params: dict,
    llm_params: dict,
    cfg: ForcedAlignerConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    audio_start_embed: jnp.ndarray,
    audio_end_embed: jnp.ndarray,
    text_ids: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Front half of :func:`forward`: raw audio + text/timestamp ids ->
    (mel, compacted prompt embeds, valid_len). Split out so stage probes
    snapshot the exact pipeline stages."""
    acfg = cfg.asr
    mel_cfg = acfg.mel_config()
    mel = log_mel_spectrogram(audio, mel_cfg)
    window_frames = acfg.chunk_frames * acfg.chunks_per_window
    pad = (-mel.shape[1]) % window_frames
    if pad:
        mel = jnp.pad(mel, ((0, 0), (0, pad), (0, 0)))
    valid_frames = (valid_samples // mel_cfg.hop_length).astype(jnp.int32)
    audio_tokens, audio_valid = encode_audio(tower_params, acfg, mel, valid_frames)

    text_embed = llm_params["embed"][text_ids].astype(audio_tokens.dtype)
    embeds, valid_len = assemble_prompt(
        audio_start_embed, jnp.zeros((1, 0, text_embed.shape[-1]), text_embed.dtype),
        jnp.zeros((1, 0, text_embed.shape[-1]), text_embed.dtype),
        audio_tokens, audio_valid,
        jnp.concatenate([audio_end_embed, text_embed], axis=1),
    )
    return mel, embeds, valid_len


def forward(
    tower_params: dict,
    llm_params: dict,
    head: dict,
    cfg: ForcedAlignerConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    audio_start_embed: jnp.ndarray,
    audio_end_embed: jnp.ndarray,
    text_ids: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio + text/timestamp ids -> per-position buckets.

    Returns (buckets (1, L), valid_len (1,)); positions of ``<timestamp>``
    ids in the compacted prompt are at
    ``1 + audio_valid + 1 + index_in_text``.
    """
    _mel, embeds, valid_len = prompt_for(
        tower_params, llm_params, cfg, audio, valid_samples,
        audio_start_embed, audio_end_embed, text_ids)
    return align_embeds(llm_params, head, cfg, embeds, valid_len), valid_len


def fix_timestamps(buckets: list[int]) -> list[int]:
    """Monotone repair via longest non-decreasing subsequence (reference
    ``Inference_Qwen_ForcedAligner_ONNX.py:250-320`` semantics): keep the
    LIS as anchors; short anomaly runs (<=2) snap to the nearest anchor,
    longer runs are linearly interpolated between anchors."""
    data = [int(x) for x in buckets]
    n = len(data)
    if n == 0:
        return []
    dp = [1] * n
    parent = [-1] * n
    for i in range(1, n):
        for j in range(i):
            if data[j] <= data[i] and dp[j] + 1 > dp[i]:
                dp[i] = dp[j] + 1
                parent[i] = j
    idx = dp.index(max(dp))
    normal = [False] * n
    while idx != -1:
        normal[idx] = True
        idx = parent[idx]
    result = data.copy()
    i = 0
    while i < n:
        if normal[i]:
            i += 1
            continue
        j = i
        while j < n and not normal[j]:
            j += 1
        left = next((result[k] for k in range(i - 1, -1, -1) if normal[k]), None)
        right = next((result[k] for k in range(j, n) if normal[k]), None)
        count = j - i
        for k in range(i, j):
            if count <= 2:
                if left is None:
                    result[k] = right
                elif right is None:
                    result[k] = left
                else:
                    result[k] = left if (k - (i - 1)) <= (j - k) else right
            else:
                if left is not None and right is not None:
                    result[k] = int(left + (right - left) / (count + 1) * (k - i + 1))
                elif left is not None:
                    result[k] = left
                elif right is not None:
                    result[k] = right
        i = j
    return [int(x) for x in result]


def word_timestamps(
    words: list[str], buckets: list[int], tokens_per_word: int, segment_ms: int = 80
) -> list[dict]:
    """Group fixed buckets into per-word start/end times (milliseconds)."""
    fixed = fix_timestamps(buckets)
    out = []
    for i, w in enumerate(words):
        grp = fixed[i * tokens_per_word : (i + 1) * tokens_per_word]
        if not grp:
            break
        out.append({"text": w, "start_ms": grp[0] * segment_ms, "end_ms": grp[-1] * segment_ms})
    return out
