"""Nemotron 3.5 ASR: cache-aware FastConformer + RNN-T (offline mode).

Capability parity with reference ``Nemotron/Export_Nemotron_ASR.py`` (2,119
LoC, offline graph ``NemotronEncoder:456-694``): NeMo mel (no per-feature
norm), **causal** pre-encode conv chain (time pads folded for streaming
bit-exactness: first conv pads ``2 + pre_encode_cache`` top / 1 bottom,
then ``drop_extra`` frames dropped), rel-pos conformer blocks with a
**chunked block attention mask** (chunk = right_context + 1 frames, left
context bounded) reproducing cache-aware streaming, causal left-pad conv
modules with LayerNorm, multilingual prompt projection folded into the
joint's encoder side, LSTM predictor + RNN-T joint with
``max_symbols_per_frame`` greedy. The streaming (chunk-step, cache-carry)
variant shares these weights and lives with the other streaming sessions.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.decode.rnnt import rnnt_greedy
from asr_jax.frontend.nemo_mel import NemoMelConfig, log_mel
from asr_jax.layers.attention import NEG_INF
from asr_jax.layers.conformer import relative_position_embedding, rel_pos_attention
from asr_jax.layers.lstm import init_lstm_params, lstm_step_stack
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import depthwise_conv1d_time
from asr_jax.layers.transformer import dense


@dataclasses.dataclass(frozen=True)
class NemotronConfig:
    vocab_size: int = 8192           # without blank; blank id = vocab_size
    d_model: int = 1024
    num_layers: int = 24
    num_heads: int = 8
    ffn_dim: int = 4096
    conv_kernel: int = 9
    sub_channels: int = 256
    pred_hidden: int = 640
    joint_hidden: int = 640
    prompt_hidden: int = 640
    lstm_layers: int = 2
    num_prompts: int = 128
    left_context: int = 70
    right_context: int = 13          # chunk = right + 1 encoder frames
    drop_extra: int = 2
    pre_encode_cache: int = 9        # sub_factor + 1
    max_symbols_per_frame: int = 10
    sample_rate: int = 16000
    mel: NemoMelConfig = NemoMelConfig(n_mels=128)

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def chunk(self) -> int:
        return self.right_context + 1


def init_params(cfg: NemotronConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
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
            "norm_ff1": norm(), "ff1": {"w1": lin(d, f, False), "w2": lin(f, d, False)},
            "norm_att": norm(),
            "attn": {
                "q": lin(d, d, False), "k": lin(d, d, False), "v": lin(d, d, False),
                "o": lin(d, d, False),
                "rel_k": {"w": (jax.random.normal(next(keys), (d, d)) * (d ** -0.5)).astype(dtype)},
                "bias_u": jnp.zeros((cfg.num_heads, d // cfg.num_heads), dtype),
                "bias_v": jnp.zeros((cfg.num_heads, d // cfg.num_heads), dtype),
            },
            "norm_conv": norm(),
            "conv": {
                "pw1": lin(d, 2 * d, False),
                "dw": {"w": (jax.random.normal(next(keys), (cfg.conv_kernel, d)) * 0.1).astype(dtype)},
                "ln": norm(),
                "pw2": lin(d, d, False),
            },
            "norm_ff2": norm(), "ff2": {"w1": lin(d, f, False), "w2": lin(f, d, False)},
            "norm_out": norm(),
        }

    m = cfg.mel.n_mels
    freq = m
    for _ in range(3):
        freq = (freq + 2 + 1 - 3) // 2 + 1  # W pads (2, 1), kernel 3, stride 2
    return {
        "pre_encode": {
            "conv0": {"w": (jax.random.normal(next(keys), (3, 3, 1, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "dw1": {"w": (jax.random.normal(next(keys), (3, 3, 1, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "pw1": {"w": (jax.random.normal(next(keys), (1, 1, ch, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "dw2": {"w": (jax.random.normal(next(keys), (3, 3, 1, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "pw2": {"w": (jax.random.normal(next(keys), (1, 1, ch, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "out": lin(ch * freq, d),
        },
        "blocks": [block() for _ in range(cfg.num_layers)],
        "prompt": {
            "w0_enc": (jax.random.normal(next(keys), (d, cfg.prompt_hidden)) * (d ** -0.5)).astype(dtype),
            "bias_table": (jax.random.normal(next(keys), (cfg.num_prompts, cfg.prompt_hidden)) * 0.02).astype(dtype),
            "w2": lin(cfg.prompt_hidden, cfg.prompt_hidden),
            "joint_enc": lin(cfg.prompt_hidden, cfg.joint_hidden),
        },
        "decoder": {
            "embed": (jax.random.normal(next(keys), (cfg.vocab_size + 1, cfg.pred_hidden)) * 0.02).astype(dtype),
            "lstm": init_lstm_params(next(keys), cfg.pred_hidden, cfg.pred_hidden, cfg.lstm_layers, dtype),
            "pred": lin(cfg.pred_hidden, cfg.joint_hidden),
            "joint_net": lin(cfg.joint_hidden, cfg.vocab_size + 1),
        },
    }


def _causal_conv2d(x, w, b, groups=1, pad_top=2):
    """NHWC conv, kernel 3, stride 2, pads: H(time) = (pad_top, 1),
    W(mel) = (2, 1) — reference ``_ASYMMETRIC_CONV_2D``."""
    y = jax.lax.conv_general_dilated(
        x, w, (2, 2), [(pad_top, 1), (2, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
    )
    if b is not None:
        y = y + b
    return y


def pre_encode(params: dict, cfg: NemotronConfig, feats: jnp.ndarray, valid: jnp.ndarray):
    """feats (B, T, M) -> (B, T', D). Causal conv chain + drop_extra."""
    p = params["pre_encode"]
    ch = p["conv0"]["w"].shape[-1]
    x = feats[..., None]
    pad0 = 2 + cfg.pre_encode_cache
    x = jax.nn.relu(_causal_conv2d(x, p["conv0"]["w"], p["conv0"]["b"], 1, pad0))
    valid = (valid + pad0 + 1 - 3) // 2 + 1
    x = _causal_conv2d(x, p["dw1"]["w"], p["dw1"]["b"], ch)
    valid = (valid + 2 + 1 - 3) // 2 + 1
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, p["pw1"]["w"], (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["pw1"]["b"])
    x = _causal_conv2d(x, p["dw2"]["w"], p["dw2"]["b"], ch)
    valid = (valid + 2 + 1 - 3) // 2 + 1
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, p["pw2"]["w"], (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["pw2"]["b"])
    b, t = x.shape[0], x.shape[1]
    x = x.transpose(0, 1, 3, 2).reshape(b, t, -1)  # channel-major flatten (torch parity)
    x = dense(x, p["out"])
    x = x[:, cfg.drop_extra :]
    valid = jnp.maximum(valid - cfg.drop_extra, 0)
    return x, valid


@functools.lru_cache(maxsize=8)
def _chunk_mask_np(t: int, chunk: int, left: int, right: int) -> np.ndarray:
    """Block mask reproducing cache-aware chunked attention
    (reference ``Export_Nemotron_ASR.py:501-509``)."""
    idx = np.arange(t)
    chunk_start = (idx // chunk) * chunk
    lo = (chunk_start - left)[:, None]
    hi = (chunk_start + right)[:, None]
    valid = (idx[None, :] >= lo) & (idx[None, :] <= hi)
    return np.where(valid, 0.0, NEG_INF).astype(np.float32)


def conv_module_causal(x: jnp.ndarray, p: dict, key_mask) -> jnp.ndarray:
    y = dense(x, p["pw1"])
    a, g = jnp.split(y, 2, axis=-1)
    y = a * jax.nn.sigmoid(g)
    if key_mask is not None:
        y = jnp.where(key_mask[..., None], y, 0)
    k = p["dw"]["w"].shape[0]
    y = depthwise_conv1d_time(y, p["dw"]["w"], k - 1, 0)  # fully causal left pad
    if "b" in p["dw"]:
        y = y + p["dw"]["b"]
    y = layer_norm(y, p["ln"]["scale"], p["ln"]["bias"])
    y = jax.nn.silu(y)
    return dense(y, p["pw2"])


def encode_features(
    params: dict, cfg: NemotronConfig, mel: jnp.ndarray, valid_frames: jnp.ndarray,
    prompt_id: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Zero-masked mel (B, T, M) -> (joint-projected frames, valid counts)."""
    x, valid = pre_encode(params, cfg, mel.astype(params["prompt"]["w0_enc"].dtype), valid_frames)

    t = x.shape[1]
    pe = jnp.asarray(relative_position_embedding(t, cfg.d_model), x.dtype)
    key_mask = jnp.arange(t, dtype=jnp.int32)[None, :] < valid[:, None]
    bias = jnp.asarray(_chunk_mask_np(t, cfg.chunk, cfg.left_context, cfg.right_context))[None, None]
    bias = bias + jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :]
    for p in params["blocks"]:
        x = x + 0.5 * dense(jax.nn.silu(dense(layer_norm(x, p["norm_ff1"]["scale"], p["norm_ff1"]["bias"]), p["ff1"]["w1"])), p["ff1"]["w2"])
        y = layer_norm(x, p["norm_att"]["scale"], p["norm_att"]["bias"])
        x = x + rel_pos_attention(y, p["attn"], cfg.num_heads, pe, bias)
        y = layer_norm(x, p["norm_conv"]["scale"], p["norm_conv"]["bias"])
        x = x + conv_module_causal(y, p["conv"], key_mask)
        x = x + 0.5 * dense(jax.nn.silu(dense(layer_norm(x, p["norm_ff2"]["scale"], p["norm_ff2"]["bias"]), p["ff2"]["w1"])), p["ff2"]["w2"])
        x = layer_norm(x, p["norm_out"]["scale"], p["norm_out"]["bias"])

    pr = params["prompt"]
    h0 = jax.nn.relu(jnp.dot(x, pr["w0_enc"]) + pr["bias_table"][prompt_id][:, None, :])
    h0 = dense(h0, pr["w2"])
    enc_proj = dense(h0, pr["joint_enc"])
    return enc_proj, valid


def encode(
    params: dict, cfg: NemotronConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray,
    prompt_id: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio -> (joint-projected encoder frames (B, T', joint_hidden), valid)."""
    mel = log_mel(audio, cfg.mel)
    valid_frames = cfg.mel.valid_frames(valid_samples)
    keep = jnp.arange(mel.shape[1], dtype=jnp.int32)[None, :] < valid_frames[:, None]
    mel = jnp.where(keep[..., None], mel, 0.0)
    return encode_features(params, cfg, mel, valid_frames, prompt_id)


def joint_step(params: dict, token: jnp.ndarray, h: jnp.ndarray, c: jnp.ndarray, enc_frame: jnp.ndarray):
    dec = params["decoder"]
    emb = dec["embed"][token]
    y, h2, c2 = lstm_step_stack(emb, h, c, dec["lstm"])
    pred = dense(y, dec["pred"])
    z = jax.nn.relu(enc_frame + pred)
    return dense(z, dec["joint_net"]), h2, c2


@functools.partial(jax.jit, static_argnames=("cfg", "max_tokens"))
def forward(
    params: dict,
    cfg: NemotronConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    prompt_id: jnp.ndarray,
    max_tokens: int = 256,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio -> (token_ids, counts) via RNN-T greedy."""
    enc, valid = encode(params, cfg, audio, valid_samples, prompt_id)
    b = enc.shape[0]
    h0 = jnp.zeros((cfg.lstm_layers, b, cfg.pred_hidden), enc.dtype)
    c0 = jnp.zeros((cfg.lstm_layers, b, cfg.pred_hidden), enc.dtype)

    def step(token, h, c, enc_frame):
        return joint_step(params, token, h, c, enc_frame)

    return rnnt_greedy(
        step, enc, valid, h0, c0,
        start_token=cfg.blank_id, blank_id=cfg.blank_id,
        max_tokens=max_tokens, max_symbols_per_frame=cfg.max_symbols_per_frame,
    )
