"""FireRedASR-AED: Conformer encoder (espnet-style rel-pos) + AR decoder.

Capability parity with reference ``FireRedASR/Export_FireRedASR_AED.py`` +
``Inference_FireRedASR_AED_ONNX.py`` (5,914 LoC): Kaldi-framed fbank with a
povey (hann^0.85) window and **HTK** mel banks + CMVN ``(x - means) *
inv_std``, 6 appended zero lookahead frames, Conv2d (k3, s2, no pad) x2
subsampling, conformer blocks
  out = x + 0.5*ffn1_net; mhsa(+res); conv(+res, GLU d*4 -> 2d, depthwise
  k33, LayerNorm, swish); out = out + 0.5*ffn2_net; block LayerNorm
with Transformer-XL relative attention (per-layer pos projection, bias_u /
bias_v, rel-shift skew), and a pre-LN transformer AR decoder (self-KV cache
+ per-layer cross-KV over encoder output, exact-GELU MLP, sqrt(d)-scaled
tied embedding + sinusoidal positions) driven by the shared
greedy/penalty/sampling loop.
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
from asr_jax.layers.attention import NEG_INF, length_mask
from asr_jax.layers.conformer import rel_shift, relative_position_embedding
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import depthwise_conv1d_time
from asr_jax.layers.transformer import cross_kv, decoder_block, dense


@dataclasses.dataclass(frozen=True)
class FireRedConfig:
    vocab_size: int = 7832
    n_mels: int = 80
    d_model: int = 1280
    enc_layers: int = 16
    enc_heads: int = 20
    conv_kernel: int = 33
    dec_layers: int = 16
    dec_heads: int = 20
    dec_ffn: int = 5120
    sos_id: int = 3
    eos_id: int = 4
    pad_lookahead: int = 6          # zero frames appended before subsampling
    max_target_positions: int = 448
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig(window="povey", mel_style="htk")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.enc_heads


def init_params(cfg: FireRedConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 8192))
    d = cfg.d_model

    def lin(i, o, bias=True):
        p = {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def norm(dd=d):
        return {"scale": jnp.ones((dd,), dtype), "bias": jnp.zeros((dd,), dtype)}

    def enc_block():
        return {
            "ffn1": {"norm": norm(), "w1": lin(d, 4 * d), "w2": lin(4 * d, d)},
            "attn": {
                "norm_q": norm(), "norm_k": norm(), "norm_v": norm(),
                "q": lin(d, d, False), "k": lin(d, d, False), "v": lin(d, d, False),
                "pos": {"w": (jax.random.normal(next(keys), (d, d)) * (d ** -0.5)).astype(dtype)},
                "bias_u": jnp.zeros((cfg.enc_heads, cfg.head_dim), dtype),
                "bias_v": jnp.zeros((cfg.enc_heads, cfg.head_dim), dtype),
                "o": lin(d, d, False),
            },
            "conv": {
                "norm": norm(),
                "pw1": lin(d, 4 * d, False),
                "dw": {"w": (jax.random.normal(next(keys), (cfg.conv_kernel, 2 * d)) * 0.05).astype(dtype)},
                "ln": norm(2 * d),
                "pw2": lin(2 * d, d, False),
            },
            "ffn2": {"norm": norm(), "w1": lin(d, 4 * d), "w2": lin(4 * d, d)},
            "norm_out": norm(),
        }

    def dec_block():
        return {
            "ln1": norm(),
            "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d, False)},
            "ln_cross": norm(),
            "cross": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d, False)},
            "ln2": norm(),
            "mlp": {"fc1": lin(d, cfg.dec_ffn), "fc2": lin(cfg.dec_ffn, d)},
        }

    ch = 32
    sub_freq = ((cfg.n_mels - 1) // 2 - 1) // 2
    return {
        "cmvn_means": jnp.zeros((cfg.n_mels,), dtype),
        "cmvn_istd": jnp.ones((cfg.n_mels,), dtype),
        "subsample": {
            "conv0": {"w": (jax.random.normal(next(keys), (3, 3, 1, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "conv1": {"w": (jax.random.normal(next(keys), (3, 3, ch, ch)) * 0.1).astype(dtype), "b": jnp.zeros((ch,), dtype)},
            "out": lin(ch * sub_freq, d),
        },
        "enc_blocks": [enc_block() for _ in range(cfg.enc_layers)],
        "decoder": {
            "embed": (jax.random.normal(next(keys), (cfg.vocab_size, d)) * 0.02).astype(dtype),
            "blocks": [dec_block() for _ in range(cfg.dec_layers)],
            "ln": norm(),
        },
    }


def _ffn(x, p):
    y = layer_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    return dense(jax.nn.silu(dense(y, p["w1"])), p["w2"])


def _rel_attention(x, p, heads, pos_embed, bias):
    b, s, d = x.shape
    hd = d // heads
    q = dense(layer_norm(x, p["norm_q"]["scale"], p["norm_q"]["bias"]), p["q"])
    k = dense(layer_norm(x, p["norm_k"]["scale"], p["norm_k"]["bias"]), p["k"])
    v = dense(layer_norm(x, p["norm_v"]["scale"], p["norm_v"]["bias"]), p["v"])
    q = q.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)
    k = k.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)
    v = v.reshape(b, s, heads, hd).transpose(0, 2, 1, 3)
    rel_k = dense(pos_embed, p["pos"]).reshape(-1, heads, hd)
    qu = q + p["bias_u"][None, :, None, :]
    qv = q + p["bias_v"][None, :, None, :]
    ac = jnp.einsum("bhsd,bhtd->bhst", qu, k)
    bd = rel_shift(jnp.einsum("bhsd,phd->bhsp", qv, rel_k))[..., :s]
    scores = (ac + bd).astype(jnp.float32) * (hd ** -0.5) + bias
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    # Reference re-zeros masked keys after softmax (masked_fill attn 0).
    ctx = jnp.einsum("bhst,bhtd->bshd", probs, v).reshape(b, s, d)
    return dense(ctx, p["o"])


def _conv_module(x, p, key_mask):
    y = layer_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    y = jnp.where(key_mask[..., None], y, 0)
    y = dense(y, p["pw1"])  # (B, S, 4d)
    a, g = jnp.split(y, 2, axis=-1)
    y = a * jax.nn.sigmoid(g)  # GLU -> 2d
    k = p["dw"]["w"].shape[0]
    pad = (k - 1) // 2
    y = depthwise_conv1d_time(y, p["dw"]["w"], pad, pad)
    if "b" in p["dw"]:
        y = y + p["dw"]["b"]
    y = layer_norm(y, p["ln"]["scale"], p["ln"]["bias"])
    y = jax.nn.silu(y)
    y = dense(y, p["pw2"])
    return jnp.where(key_mask[..., None], y, 0)


def encode(
    params: dict, cfg: FireRedConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio (B, S) int16-range -> (enc (B, T', D), valid counts)."""
    fb = cfg.fbank
    n_frames = fb.num_frames(audio.shape[-1])
    mel = log_mel_fbank(audio, fb, n_frames)
    valid_frames = jnp.maximum((valid_samples - fb.win_length) // fb.hop_length + 1, 0).astype(jnp.int32)
    return encode_from_mel(params, cfg, mel, valid_frames)


def encode_from_mel(
    params: dict, cfg: FireRedConfig, mel: jnp.ndarray, valid_frames: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mel features (B, T, n_mels) -> (enc, valid): CMVN, lookahead pad,
    Conv2d subsampling, conformer stack.  Feature-level entry shared by the
    audio path and the full-geometry parity tests."""
    n_frames = mel.shape[1]
    mel = (mel - params["cmvn_means"]) * params["cmvn_istd"]
    keep = length_mask(valid_frames, n_frames)
    mel = jnp.where(keep[..., None], mel, 0.0)
    mel = jnp.pad(mel, ((0, 0), (0, cfg.pad_lookahead), (0, 0)))

    # Conv2dSubsampling: 2x (k3, s2, no pad) + relu, freq and time.
    x = mel[..., None]  # NHWC, H=time, W=mel
    sub = params["subsample"]
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, sub["conv0"]["w"], (2, 2), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + sub["conv0"]["b"])
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, sub["conv1"]["w"], (2, 2), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + sub["conv1"]["b"])
    b, t = x.shape[0], x.shape[1]
    x = x.transpose(0, 1, 3, 2).reshape(b, t, -1)  # channel-major flatten
    x = dense(x, sub["out"])
    valid = ((valid_frames - 3) // 2 + 1 - 3) // 2 + 1

    pe = jnp.asarray(relative_position_embedding(t, cfg.d_model), x.dtype)
    key_mask = length_mask(valid, t)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    for p in params["enc_blocks"]:
        x = x + 0.5 * _ffn(x, p["ffn1"])
        x = x + _rel_attention(x, p["attn"], cfg.enc_heads, pe, bias)
        x = x + _conv_module(x, p["conv"], key_mask)
        x = x + 0.5 * _ffn(x, p["ffn2"])
        x = layer_norm(x, p["norm_out"]["scale"], p["norm_out"]["bias"])
    return x, valid


def make_state(params: dict, cfg: FireRedConfig, enc: jnp.ndarray) -> dict:
    b = enc.shape[0]
    t_max = cfg.max_target_positions
    h, hd = cfg.dec_heads, cfg.d_model // cfg.dec_heads
    layers = []
    for p in params["decoder"]["blocks"]:
        ck, cv = cross_kv(enc, p, cfg.dec_heads)
        layers.append({
            "cross_k": ck, "cross_v": cv,
            "self_k": jnp.zeros((b, t_max, h, hd), enc.dtype),
            "self_v": jnp.zeros((b, t_max, h, hd), enc.dtype),
        })
    return {"layers": tuple(layers)}


def _decoder_pass(params, cfg, state, tokens, pos, cross_bias):
    dec = params["decoder"]
    d = cfg.d_model
    s = tokens.shape[1]
    # Absolute sinusoid positions 0..t_max-1: rows [0, t_max) of the relative
    # table hold positions t_max-1..0, so reverse that slice.
    pe = jnp.asarray(relative_position_embedding(cfg.max_target_positions, d))
    pos_table = pe[: cfg.max_target_positions][::-1]
    x = dec["embed"][tokens] * (d ** 0.5)
    x = x + jax.lax.dynamic_slice(pos_table, (pos, 0), (s, d))[None]
    x = x.astype(dec["embed"].dtype)
    new_layers = []
    for p, lstate in zip(dec["blocks"], state["layers"]):
        x, nk, nv = decoder_block(
            x, p, cfg.dec_heads, lstate["self_k"], lstate["self_v"], pos,
            lstate["cross_k"], lstate["cross_v"], cross_bias=cross_bias,
        )
        new_layers.append({**lstate, "self_k": nk, "self_v": nv})
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    # Tied embedding by default; checkpoints with an untied tgt_word_prj
    # carry it as dec["out"] (loaders/firered.py keeps the tie one-sourced
    # when the tensors are byte-identical).
    logits = embedding_logits(dec["out"] if "out" in dec else dec["embed"], x)
    return logits, {"layers": tuple(new_layers)}


@functools.partial(jax.jit, static_argnames=("cfg", "decode_cfg"))
def prefill_window(
    params: dict,
    cfg: FireRedConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    decode_cfg: DecodeConfig,
) -> dict[str, jnp.ndarray]:
    """Encoder + [SOS] prefill for one window — the front half of
    :func:`transcribe`, split out so the continuous AED engine
    (``parallel/aed_batcher.py``) prefills one request independently of
    everyone else's decode steps. Returns ``state`` (prefilled decode
    state), ``logits0`` (B, V) suppressed, ``enc_valid`` (B,)."""
    enc, enc_valid = encode(params, cfg, audio, valid_samples)
    cross_bias = jnp.where(length_mask(enc_valid, enc.shape[1]), 0.0, NEG_INF)[
        :, None, None, :
    ].astype(jnp.float32)
    state = make_state(params, cfg, enc)
    prompt = jnp.full((audio.shape[0], 1), cfg.sos_id, jnp.int32)
    logits, state = _decoder_pass(params, cfg, state, prompt,
                                  jnp.asarray(0, jnp.int32), cross_bias)
    logits0 = suppress_tokens(logits[:, -1].astype(jnp.float32),
                              decode_cfg.suppress_ids)
    return {"state": state, "logits0": logits0, "enc_valid": enc_valid,
            "enc": enc}


@functools.partial(jax.jit, static_argnames=("cfg", "decode_cfg"))
def transcribe(
    params: dict,
    cfg: FireRedConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    decode_cfg: DecodeConfig,
    rng: jax.Array | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Raw audio -> (tokens (B, 1 + max_new + 1), counts) starting from [SOS]."""
    pre = prefill_window(params, cfg, audio, valid_samples, decode_cfg)
    enc, enc_valid = pre["enc"], pre["enc_valid"]
    state, logits0 = pre["state"], pre["logits0"]
    cross_bias = jnp.where(length_mask(enc_valid, enc.shape[1]), 0.0, NEG_INF)[
        :, None, None, :
    ].astype(jnp.float32)
    b = audio.shape[0]
    t_total = 1 + decode_cfg.max_new_tokens + 1
    buf = jnp.zeros((b, t_total), jnp.int32).at[:, 0].set(cfg.sos_id)
    if rng is None:
        rng = jax.random.PRNGKey(0)
    first, rng = select_token(logits0, buf, jnp.asarray(1, jnp.int32), decode_cfg, rng,
                              history_start=1)

    def step(state, token, pos):
        lg, state = _decoder_pass(params, cfg, state, token, pos, cross_bias)
        return lg[:, -1], state

    return ar_decode(step, state, jnp.asarray(1, jnp.int32), first, buf, decode_cfg, rng)
