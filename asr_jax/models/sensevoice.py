"""SenseVoiceSmall: Kaldi fbank -> LFR/CMVN -> SANM encoder -> CTC head.

Capability parity with reference ``SenseVoice/Export_SenseVoice.py`` (855
LoC): language + system(emotion) prompt embeddings prepended to LFR
features, 70 SANM blocks (encoders0 1 + encoders 49 + tp_encoders 20 for
SenseVoiceSmall), CTC argmax + repeat/blank collapse, 7-row language table
(auto/zh/en/yue/ja/ko/nospeech -> rows 0..6, prompt token ids
0/3/4/7/11/12/13, reference ``Export_SenseVoice.py:157-168``).

Differences: batched fixed-shape forward with per-sample valid
lengths (masked attention + masked FSMN), one jit, no graph surgery; the
export-time folds of the reference are unnecessary (XLA fuses) so the
checkpoint's original math is used directly.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.decode.ctc import ctc_greedy_collapse
from asr_jax.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_jax.frontend.lfr import apply_cmvn_addmul, lfr_stack
from asr_jax.layers.attention import NEG_INF, length_mask
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import sanm_block

# (code, description, aliases, prompt_token_id) — table row order is the
# language_embed row index (reference SENSEVOICE_LANGUAGE_PROFILES).
LANGUAGE_PROFILES = (
    ("auto", "Automatic language detection", ("automatic", "detect"), 0),
    ("zh", "Chinese", ("Chinese", "Mandarin", "zh-CN", "中文"), 3),
    ("en", "English", ("English", "en-US"), 4),
    ("yue", "Cantonese", ("Cantonese", "zh-yue", "粤语", "粵語"), 7),
    ("ja", "Japanese", ("Japanese", "jp", "日本語"), 11),
    ("ko", "Korean", ("Korean", "kr", "한국어"), 12),
    ("nospeech", "No speech", ("no-speech", "silence"), 13),
)


@dataclasses.dataclass(frozen=True)
class SenseVoiceConfig:
    vocab_size: int = 25055
    hidden: int = 512
    num_heads: int = 4
    head_dim: int = 128
    ffn_dim: int = 2048
    num_encoders0: int = 1
    num_encoders: int = 49
    num_tp_encoders: int = 20
    fsmn_kernel: int = 11
    n_mels: int = 80
    lfr_m: int = 7
    lfr_n: int = 6
    blank_id: int = 0
    use_emotion: bool = True
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def feature_size(self) -> int:
        return self.n_mels * self.lfr_m  # 560

    @property
    def prompt_len(self) -> int:
        return 4 if self.use_emotion else 3  # 1 language + system prompt

    @property
    def system_prompt_ids(self) -> tuple[int, ...]:
        return (1, 2, 14) if self.use_emotion else (5, 14)


def sinusoid_position_encoding(length: int, depth: int, start: int = 1) -> np.ndarray:
    """FunASR sinusoidal PE: positions start at 1 (reference
    ``Export_SenseVoice.py:187-193``)."""
    positions = np.arange(start, start + length, dtype=np.float32)[:, None]
    log_inc = np.log(10000.0) / (depth / 2 - 1)
    inv = np.exp(np.arange(depth / 2, dtype=np.float32) * -log_inc)[None, :]
    scaled = positions * inv
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_params(cfg: SenseVoiceConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    """Random-init pytree with the checkpoint's exact layout (for tests/bench)."""
    keys = iter(jax.random.split(rng, 1024))

    def dense(i, o):
        return {
            "w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype),
            "b": jnp.zeros((o,), dtype),
        }

    def norm():
        return {"scale": jnp.ones((cfg.hidden,), dtype), "bias": jnp.zeros((cfg.hidden,), dtype)}

    def block(in_size):
        p = {
            "norm1": {"scale": jnp.ones((in_size,), dtype), "bias": jnp.zeros((in_size,), dtype)},
            "qkv": dense(in_size, 3 * cfg.hidden),
            "fsmn_w": (jax.random.normal(next(keys), (cfg.fsmn_kernel, cfg.hidden)) * 0.1).astype(dtype),
            "out": dense(cfg.hidden, cfg.hidden),
            "norm2": norm(),
            "ffn": {
                "w1": dense(cfg.hidden, cfg.ffn_dim)["w"],
                "b1": jnp.zeros((cfg.ffn_dim,), dtype),
                "w2": dense(cfg.ffn_dim, cfg.hidden)["w"],
                "b2": jnp.zeros((cfg.hidden,), dtype),
            },
        }
        return p

    f = cfg.feature_size
    return {
        "cmvn_means": jnp.zeros((f,), dtype),
        "cmvn_istd": jnp.ones((f,), dtype),
        "language_embed": (jax.random.normal(next(keys), (len(LANGUAGE_PROFILES), f)) * 0.02).astype(dtype),
        "system_embed": (jax.random.normal(next(keys), (len(cfg.system_prompt_ids), f)) * 0.02).astype(dtype),
        "encoders0": [block(f) for _ in range(cfg.num_encoders0)],
        "encoders": [block(cfg.hidden) for _ in range(cfg.num_encoders)],
        "tp_encoders": [block(cfg.hidden) for _ in range(cfg.num_tp_encoders)],
        "after_norm": norm(),
        "tp_norm": norm(),
        "ctc": dense(cfg.hidden, cfg.vocab_size),
    }


def encode(params: dict, cfg: SenseVoiceConfig, x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """SANM encoder over prompt+speech features. x: (B, T, feature_size)."""
    t = x.shape[1]
    key_mask = length_mask(valid, t)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    x = jnp.where(key_mask[..., None], x, 0)
    for i, p in enumerate(params["encoders0"]):
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=False)
    for p in params["encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    x = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])
    for p in params["tp_encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    return layer_norm(x, params["tp_norm"]["scale"], params["tp_norm"]["bias"])


@functools.partial(jax.jit, static_argnames=("cfg",))
def forward(
    params: dict,
    cfg: SenseVoiceConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    language_idx: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio -> compacted CTC token ids.

    Args:
      audio: ``(B, S)`` waveform, int16 numeric range (Kaldi convention).
      valid_samples: ``(B,)`` int32 valid sample counts.
      language_idx: ``(B,)`` int32 row in LANGUAGE_PROFILES.

    Returns:
      token_ids ``(B, T_seq)`` int32 (left-compacted), num_ids ``(B,)``.
    """
    logits, valid_seq = encode_logits(params, cfg, audio, valid_samples, language_idx)
    ids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    return ctc_greedy_collapse(ids, valid_seq, cfg.blank_id)


def encode_logits(
    params: dict, cfg: SenseVoiceConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray, language_idx: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Same as :func:`forward` but returns (logits, valid_seq) — used by
    CTC training and tests."""
    fb = cfg.fbank
    n_frames = fb.num_frames(audio.shape[-1])
    mel = log_mel_fbank(audio, fb, n_frames)
    valid_frames = jnp.maximum((valid_samples - fb.win_length) // fb.hop_length + 1, 0).astype(jnp.int32)
    feats = lfr_stack(mel, cfg.lfr_m, cfg.lfr_n, valid_frames)
    valid_lfr = (valid_frames + cfg.lfr_n - 1) // cfg.lfr_n
    return encode_logits_from_lfr(params, cfg, feats, valid_lfr, language_idx)


def encode_logits_from_lfr(
    params: dict, cfg: SenseVoiceConfig, feats: jnp.ndarray, valid_lfr: jnp.ndarray, language_idx: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """LFR features (B, T, n_mels*lfr_m) -> (ctc_logits, valid_seq): CMVN,
    sinusoid PE, language/system prompt prepend, SANM encoder, CTC head.
    Features-level entry point shared by the audio path, feature-domain
    training and the full-geometry parity tests."""
    feats = apply_cmvn_addmul(feats, params["cmvn_means"], params["cmvn_istd"])
    t_lfr = feats.shape[1]
    prompt_len = cfg.prompt_len
    pe = jnp.asarray(sinusoid_position_encoding(t_lfr + prompt_len, cfg.feature_size))
    feats = feats + pe[prompt_len:][None]
    lang = params["language_embed"][language_idx] + pe[0]
    system = params["system_embed"] + pe[1:prompt_len]
    b = feats.shape[0]
    x = jnp.concatenate(
        [lang[:, None, :], jnp.broadcast_to(system[None], (b,) + system.shape), feats], axis=1
    )
    valid_seq = valid_lfr + prompt_len
    from asr_jax.layers.transformer import dense

    dtype = params["ctc"]["b"].dtype
    enc = encode(params, cfg, x.astype(dtype), valid_seq)
    logits = dense(enc, params["ctc"])
    return logits, valid_seq
