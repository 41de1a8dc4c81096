"""Parakeet-TDT: FastConformer encoder + LSTM predictor + TDT joint.

Capability parity with reference ``Parakeet/Export_Parakeet_ASR.py`` +
``Inference_Parakeet_ASR_ONNX.py`` (1,493 LoC): NeMo mel front-end with
per-feature normalization, dw-separable 8x conv subsampling, 24 rel-pos
conformer blocks, encoder projector, stateless-start 2-layer LSTM decoder,
joint head emitting (vocab + duration) logits, TDT greedy with
duration-advanced frame pointer. The reference's export folds (BN->conv,
PE table baking, qkv fusion, scale folds — ``Export_Parakeet_ASR.py:
282-376``) are load-time affines here; everything else stays checkpoint
math. Checkpoint: HF parakeet-tdt-0.6b-v3 safetensors (NeMo-free), loader
in ``asr_jax.loaders.parakeet_hf``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from asr_jax.decode.tdt import tdt_greedy
from asr_jax.frontend.nemo_mel import NemoMelConfig, log_mel, per_feature_norm
from asr_jax.layers.attention import NEG_INF, length_mask
from asr_jax.layers.conformer import (
    conformer_block,
    relative_position_embedding,
    subsample_conv2d,
)
from asr_jax.layers.lstm import init_lstm_params, lstm_step_stack
from asr_jax.layers.transformer import dense


@dataclasses.dataclass(frozen=True)
class ParakeetConfig:
    vocab_size: int = 8193          # includes blank (last id)
    blank_id: int = 8192
    d_model: int = 1024
    num_layers: int = 24
    num_heads: int = 8
    ffn_dim: int = 4096
    conv_kernel: int = 9
    sub_channels: int = 256
    sub_kernel: int = 3
    sub_stride: int = 2
    dec_hidden: int = 640
    lstm_layers: int = 2
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)
    scale_input: bool = True     # NeMo xscale: multiply subsampled states by sqrt(d_model)
    eos_id: int | None = None
    sample_rate: int = 16000
    mel: NemoMelConfig = NemoMelConfig()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def num_durations(self) -> int:
        return len(self.durations)


def init_params(cfg: ParakeetConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 8192))
    d, f, ch = cfg.d_model, cfg.ffn_dim, cfg.sub_channels

    def lin(i, o, bias=True):
        p = {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def norm(dd=d):
        return {"scale": jnp.ones((dd,), dtype), "bias": jnp.zeros((dd,), dtype)}

    def block():
        return {
            "norm_ff1": norm(), "ff1": {"w1": lin(d, f), "w2": lin(f, d)},
            "norm_att": norm(),
            "attn": {
                "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                "rel_k": {"w": (jax.random.normal(next(keys), (d, d)) * (d ** -0.5)).astype(dtype)},
                "bias_u": jnp.zeros((cfg.num_heads, cfg.head_dim), dtype),
                "bias_v": jnp.zeros((cfg.num_heads, cfg.head_dim), dtype),
            },
            "norm_conv": norm(),
            "conv": {
                "pw1": lin(d, 2 * d),
                "dw": {"w": (jax.random.normal(next(keys), (cfg.conv_kernel, d)) * 0.1).astype(dtype),
                       "b": jnp.zeros((d,), dtype)},
                "bn": {"scale": jnp.ones((d,), dtype), "shift": jnp.zeros((d,), dtype)},
                "pw2": lin(d, d),
            },
            "norm_ff2": norm(), "ff2": {"w1": lin(d, f), "w2": lin(f, d)},
            "norm_out": norm(),
        }

    k = cfg.sub_kernel
    m = cfg.mel.n_mels
    sub_out_freq = m
    for _ in range(3):
        sub_out_freq = (sub_out_freq + 2 * ((k - 1) // 2) - k) // cfg.sub_stride + 1
    return {
        "subsample": {
            "conv0": {"w": (jax.random.normal(next(keys), (k, k, 1, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "dw1": {"w": (jax.random.normal(next(keys), (k, k, 1, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "pw1": {"w": (jax.random.normal(next(keys), (1, 1, ch, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "dw2": {"w": (jax.random.normal(next(keys), (k, k, 1, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "pw2": {"w": (jax.random.normal(next(keys), (1, 1, ch, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "out": lin(ch * sub_out_freq, d),
        },
        "blocks": [block() for _ in range(cfg.num_layers)],
        "enc_proj": lin(d, cfg.dec_hidden),
        "decoder": {
            "embed": (jax.random.normal(next(keys), (cfg.vocab_size, cfg.dec_hidden)) * 0.02).astype(dtype),
            "lstm": init_lstm_params(next(keys), cfg.dec_hidden, cfg.dec_hidden, cfg.lstm_layers, dtype),
            "proj": lin(cfg.dec_hidden, cfg.dec_hidden),
            "head": lin(cfg.dec_hidden, cfg.vocab_size + cfg.num_durations),
        },
    }


def encode_features(
    params: dict, cfg: ParakeetConfig, feats: jnp.ndarray, valid_frames: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Normalized mel features (B, T, M) -> (conformer states (B, T', D),
    subsampled valid counts). No encoder projector (HF-comparable)."""
    x, valid = subsample_conv2d(
        feats, params["subsample"], valid_frames, cfg.sub_kernel, cfg.sub_stride
    )
    if cfg.scale_input:
        x = x * (cfg.d_model ** 0.5)
    t = x.shape[1]
    pe = jnp.asarray(relative_position_embedding(t, cfg.d_model), x.dtype)
    key_mask = length_mask(valid, t)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    for p in params["blocks"]:
        x = conformer_block(x, p, cfg.num_heads, pe, bias, key_mask)
    return x, valid


def encode(
    params: dict, cfg: ParakeetConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio (B, S) -> (projected encoder frames (B, T', dec_hidden),
    valid frame counts)."""
    mel = log_mel(audio, cfg.mel)
    valid_frames = cfg.mel.valid_frames(valid_samples)
    feats = per_feature_norm(mel, valid_frames, cfg.mel.norm_eps)
    x, valid = encode_features(
        params, cfg, feats.astype(params["enc_proj"]["w"].dtype), valid_frames
    )
    return dense(x, params["enc_proj"]), valid


def joint_step(params: dict, token: jnp.ndarray, h: jnp.ndarray, c: jnp.ndarray, enc_frame: jnp.ndarray):
    dec = params["decoder"]
    emb = dec["embed"][token]
    y, h2, c2 = lstm_step_stack(emb, h, c, dec["lstm"])
    dec_out = dense(y, dec["proj"])
    z = jax.nn.relu(enc_frame + dec_out)
    logits = dense(z, dec["head"])
    v = dec["embed"].shape[0]
    return logits[:, :v], logits[:, v:], h2, c2


@functools.partial(jax.jit, static_argnames=("cfg", "max_tokens", "max_symbols"))
def forward(
    params: dict,
    cfg: ParakeetConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    max_tokens: int = 256,
    max_symbols: int = 10,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio -> (token_ids (B, max_tokens), counts (B,)) via TDT greedy."""
    enc, valid = encode(params, cfg, audio, valid_samples)
    b = enc.shape[0]
    h0 = jnp.zeros((cfg.lstm_layers, b, cfg.dec_hidden), enc.dtype)
    c0 = jnp.zeros((cfg.lstm_layers, b, cfg.dec_hidden), enc.dtype)

    def step(token, h, c, enc_frame):
        return joint_step(params, token, h, c, enc_frame)

    return tdt_greedy(
        step, enc, valid, h0, c0,
        start_token=cfg.blank_id, blank_id=cfg.blank_id, durations=cfg.durations,
        max_tokens=max_tokens, max_symbols_per_step=max_symbols, eos_id=cfg.eos_id,
    )
