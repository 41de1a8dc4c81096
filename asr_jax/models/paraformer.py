"""Paraformer (non-streaming): SANM encoder + CIF predictor + non-AR decoder.

Capability parity with reference
``Paraformer/Non-Streaming/Export_Paraformer.py`` (1,074 LoC): Kaldi fbank
+ LFR + CMVN front-end, SANM encoder (shared with SenseVoice), CifPredictorV2
integrate-and-fire token extraction, and the FunASR ParaformerSANMDecoder
(FFN-first blocks: positionwise-FFN -> FSMN memory -> cross-attention, plus
trailing FFN-only blocks), emitting all tokens in one non-autoregressive
pass. zh/en profiles differ only in geometry + vocab (reference ``:41-59``).

The reference's export-time folds (LayerNorm-affine absorption in float64,
q/k scale splits, grouped cross-KV GEMMs, FSMN pad/residual folds —
``Export_Paraformer.py:239-305,439-457``) are unnecessary here: checkpoints
stay unfolded and XLA fuses. The one numerics-critical piece kept is the
f64-accuracy CIF cumsum, implemented as a compensated scan
(``asr_jax.decode.cif``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from asr_jax.decode.cif import cif_fire
from asr_jax.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_jax.frontend.lfr import apply_cmvn_addmul, lfr_stack
from asr_jax.layers.attention import NEG_INF, length_mask, mha
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import depthwise_conv1d_time, sanm_block
from asr_jax.layers.transformer import dense
from asr_jax.models.sensevoice import sinusoid_position_encoding


@dataclasses.dataclass(frozen=True)
class ParaformerConfig:
    vocab_size: int = 8404           # zh large
    hidden: int = 512
    num_heads: int = 4
    head_dim: int = 128
    ffn_dim: int = 2048
    num_encoders0: int = 1
    num_encoders: int = 49
    num_decoders: int = 16
    num_decoder_ffn: int = 1
    fsmn_kernel: int = 11
    predictor_kernel: int = 3
    tail_threshold: float = 0.45
    n_mels: int = 80
    lfr_m: int = 7
    lfr_n: int = 6
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def feature_size(self) -> int:
        return self.n_mels * self.lfr_m


def init_params(cfg: ParaformerConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 4096))
    h, f = cfg.hidden, cfg.ffn_dim

    def lin(i, o):
        return {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype),
                "b": jnp.zeros((o,), dtype)}

    def norm(d=h):
        return {"scale": jnp.ones((d,), dtype), "bias": jnp.zeros((d,), dtype)}

    def enc_block(in_size):
        return {
            "norm1": norm(in_size),
            "qkv": lin(in_size, 3 * h),
            "fsmn_w": (jax.random.normal(next(keys), (cfg.fsmn_kernel, h)) * 0.1).astype(dtype),
            "out": lin(h, h),
            "norm2": norm(),
            "ffn": {"w1": lin(h, f)["w"], "b1": jnp.zeros((f,), dtype),
                    "w2": lin(f, h)["w"], "b2": jnp.zeros((h,), dtype)},
        }

    def ffn_inner():
        return {"w1": lin(h, f), "norm": norm(f), "w2": lin(f, h)}

    def dec_block():
        return {
            "norm1": norm(),
            "ffn": ffn_inner(),
            "norm2": norm(),
            "fsmn_w": (jax.random.normal(next(keys), (cfg.fsmn_kernel, h)) * 0.1).astype(dtype),
            "norm3": norm(),
            "cross": {"q": lin(h, h), "kv": lin(h, 2 * h), "out": lin(h, h)},
        }

    fs = cfg.feature_size
    return {
        "cmvn_means": jnp.zeros((fs,), dtype),
        "cmvn_istd": jnp.ones((fs,), dtype),
        "encoders0": [enc_block(fs) for _ in range(cfg.num_encoders0)],
        "encoders": [enc_block(h) for _ in range(cfg.num_encoders)],
        "after_norm": norm(),
        "predictor": {
            "conv": {"w": (jax.random.normal(next(keys), (cfg.predictor_kernel, h, h)) * 0.02).astype(dtype),
                     "b": jnp.zeros((h,), dtype)},
            "out": lin(h, 1),
        },
        "decoders": [dec_block() for _ in range(cfg.num_decoders)],
        "decoder_ffn": [{"norm1": norm(), "ffn": ffn_inner()} for _ in range(cfg.num_decoder_ffn)],
        "decoder_after_norm": norm(),
        "output": lin(h, cfg.vocab_size),
    }


def _ffn_sanm_decoder(x: jnp.ndarray, p: dict) -> jnp.ndarray:
    """FunASR PositionwiseFeedForwardDecoderSANM: w2(norm(relu(w1(x))))."""
    h = jnp.maximum(dense(x, p["w1"]), 0)
    h = layer_norm(h, p["norm"]["scale"], p["norm"]["bias"])
    return dense(h, p["w2"])


def encode(params: dict, cfg: ParaformerConfig, x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    t = x.shape[1]
    key_mask = length_mask(valid, t)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    x = jnp.where(key_mask[..., None], x, 0)
    for p in params["encoders0"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=False)
    for p in params["encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    return layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])


def predict_alphas(params: dict, cfg: ParaformerConfig, enc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """CifPredictorV2 alpha weights: sigmoid(linear(relu(conv(enc))))."""
    p = params["predictor"]
    pad = (cfg.predictor_kernel - 1) // 2
    key_mask = length_mask(valid, enc.shape[1])
    x = jnp.where(key_mask[..., None], enc, 0)
    y = jax.lax.conv_general_dilated(
        x, p["conv"]["w"], (1,), [(pad, pad)], dimension_numbers=("NHC", "HIO", "NHC")
    ) + p["conv"]["b"]
    y = jnp.maximum(y, 0)
    alphas = jax.nn.sigmoid(dense(y, p["out"]))[..., 0]
    return jnp.where(key_mask, alphas, 0.0)


def decode_tokens(
    params: dict,
    cfg: ParaformerConfig,
    embeds: jnp.ndarray,
    counts: jnp.ndarray,
    memory: jnp.ndarray,
    memory_valid: jnp.ndarray,
) -> jnp.ndarray:
    """Non-AR decoder over fired CIF embeddings. Returns logits (B, N, V)."""
    n = embeds.shape[1]
    tok_mask = length_mask(counts, n)
    mem_bias = jnp.where(length_mask(memory_valid, memory.shape[1]), 0.0, NEG_INF)[
        :, None, None, :
    ].astype(jnp.float32)
    x = jnp.where(tok_mask[..., None], embeds, 0)
    b = x.shape[0]
    pad = (cfg.fsmn_kernel - 1) // 2
    for p in params["decoders"]:
        y = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
        sa_in = layer_norm(y, p["norm2"]["scale"], p["norm2"]["bias"])
        sa_in = jnp.where(tok_mask[..., None], sa_in, 0)
        fsmn = depthwise_conv1d_time(sa_in, p["fsmn_w"], pad, pad) + sa_in
        x = x + fsmn
        c_in = layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"])
        from asr_jax.layers.transformer import dense as _dense

        q = _dense(c_in, p["cross"]["q"]).reshape(b, n, cfg.num_heads, cfg.head_dim)
        kv = _dense(memory, p["cross"]["kv"])
        k, v = jnp.split(kv, 2, axis=-1)
        k = k.reshape(b, -1, cfg.num_heads, cfg.head_dim)
        v = v.reshape(b, -1, cfg.num_heads, cfg.head_dim)
        ctx = mha(q, k, v, bias=mem_bias).reshape(b, n, cfg.hidden)
        x = x + _dense(ctx, p["cross"]["out"])
    for p in params["decoder_ffn"]:
        x = _ffn_sanm_decoder(layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"]), p["ffn"])
    from asr_jax.layers.transformer import dense as _dense2

    x = layer_norm(x, params["decoder_after_norm"]["scale"], params["decoder_after_norm"]["bias"])
    return _dense2(x, params["output"])


def frontend_features(
    params: dict, cfg: ParaformerConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Front half of :func:`forward`: raw audio -> (mel, encoder-ready
    feats (fbank+LFR+CMVN+PE), valid_lfr). Split out so the stage probes
    (``runtime/probe.py``) snapshot the EXACT pipeline stages."""
    fb = cfg.fbank
    n_frames = fb.num_frames(audio.shape[-1])
    mel = log_mel_fbank(audio, fb, n_frames)
    valid_frames = jnp.maximum((valid_samples - fb.win_length) // fb.hop_length + 1, 0).astype(jnp.int32)
    feats = lfr_stack(mel, cfg.lfr_m, cfg.lfr_n, valid_frames)
    valid_lfr = (valid_frames + cfg.lfr_n - 1) // cfg.lfr_n
    feats = apply_cmvn_addmul(feats, params["cmvn_means"], params["cmvn_istd"])
    pe = jnp.asarray(sinusoid_position_encoding(feats.shape[1], cfg.feature_size))
    return mel, feats + pe[None], valid_lfr


@functools.partial(jax.jit, static_argnames=("cfg", "max_tokens"))
def forward(
    params: dict,
    cfg: ParaformerConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    max_tokens: int = 128,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio (B, S) int16-range -> (token_ids (B, max_tokens), counts (B,))."""
    _mel, feats, valid_lfr = frontend_features(params, cfg, audio, valid_samples)

    enc = encode(params, cfg, feats.astype(params["output"]["w"].dtype), valid_lfr)
    alphas = predict_alphas(params, cfg, enc, valid_lfr)
    embeds, counts = cif_fire(alphas, enc, valid_lfr, max_tokens, cfg.tail_threshold)
    logits = decode_tokens(params, cfg, embeds.astype(enc.dtype), counts, enc, valid_lfr)
    ids = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    tok_mask = length_mask(counts, max_tokens)
    return jnp.where(tok_mask, ids, 0), counts
