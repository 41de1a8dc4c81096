"""Dolphin v1 / CN-Dialect: E-Branchformer encoder + AR decoder + CTC head.

Capability parity with reference ``Dolphin/v1/Export_Dolphin.py`` +
``Dolphin/CN-Dialect`` (8,024 LoC): espnet (OWSM-style) front-end
(center-STFT, slaney mel f_min=0, natural log, global CMVN), Conv2d
subsampling with sqrt(d) embed scale, E-Branchformer blocks with rel-pos
attention + cgMLP/CSGU + merge conv, espnet transformer AR decoder with
self-KV cache + per-layer cross-KV, plus a CTC head over encoder output.
Two-level language control: the five-token prompt
[sos, <lang>, <region>, task, notimestamp] with lang/region auto-detected
by probing the first two decode steps (reference
``Dolphin/v1/Export_Dolphin.py:88-168,1005-1055``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig, ar_decode, select_token
from asr_jax.decode.strategies import suppress_tokens
from asr_jax.quant.quantize import embedding_logits
from asr_jax.decode.ctc import ctc_greedy_collapse
from asr_jax.frontend.espnet_mel import EspnetMelConfig, log_mel
from asr_jax.layers.attention import NEG_INF, length_mask
from asr_jax.layers.conformer import relative_position_embedding
from asr_jax.layers.ebranchformer import ebranchformer_block, init_block_params
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.transformer import cross_kv, decoder_block, dense


@dataclasses.dataclass(frozen=True)
class DolphinConfig:
    vocab_size: int = 27588
    d_model: int = 512
    enc_layers: int = 12
    enc_heads: int = 8
    enc_ffn: int = 2048
    cgmlp_dim: int = 2048
    csgu_kernel: int = 31
    fusion_kernel: int = 3
    dec_layers: int = 6
    dec_heads: int = 8
    dec_ffn: int = 2048
    sos_id: int = 27586
    eos_id: int = 27587
    language_token_start: int = 0     # loader fills real ranges from vocab
    language_token_end: int = 0
    region_token_start: int = 0
    region_token_end: int = 0
    max_target_positions: int = 448
    sample_rate: int = 16000
    mel: EspnetMelConfig = EspnetMelConfig()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.enc_heads


def init_params(cfg: DolphinConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 8192))
    d = cfg.d_model

    def lin(i, o, bias=True):
        p = {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def norm(dd=d):
        return {"scale": jnp.ones((dd,), dtype), "bias": jnp.zeros((dd,), dtype)}

    def dec_block():
        return {
            "ln1": norm(),
            "attn": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)},
            "ln_cross": norm(),
            "cross": {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d)},
            "ln2": norm(),
            "mlp": {"fc1": lin(d, cfg.dec_ffn), "fc2": lin(cfg.dec_ffn, d)},
        }

    sub_freq = ((cfg.mel.n_mels - 1) // 2 - 1) // 2
    return {
        "cmvn_mean": jnp.zeros((cfg.mel.n_mels,), dtype),
        "cmvn_istd": jnp.ones((cfg.mel.n_mels,), dtype),
        "subsample": {
            "conv0": {"w": (jax.random.normal(next(keys), (3, 3, 1, d)) * 0.05).astype(dtype), "b": jnp.zeros((d,), dtype)},
            "conv1": {"w": (jax.random.normal(next(keys), (3, 3, d, d)) * 0.05).astype(dtype), "b": jnp.zeros((d,), dtype)},
            "out": lin(d * sub_freq, d),
        },
        "enc_blocks": [
            init_block_params(next(keys), d, cfg.enc_heads, cfg.enc_ffn, cfg.cgmlp_dim,
                              cfg.csgu_kernel, cfg.fusion_kernel, dtype)
            for _ in range(cfg.enc_layers)
        ],
        "after_norm": norm(),
        "ctc": lin(d, cfg.vocab_size),
        "decoder": {
            "embed": (jax.random.normal(next(keys), (cfg.vocab_size, d)) * 0.02).astype(dtype),
            "blocks": [dec_block() for _ in range(cfg.dec_layers)],
            "ln": norm(),
        },
    }


def encode(
    params: dict, cfg: DolphinConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[-1,1] audio (B, S) -> (encoder states (B, T', D), valid counts)."""
    mel = log_mel(audio, cfg.mel)
    valid_frames = cfg.mel.valid_frames(valid_samples)
    return encode_from_mel(params, cfg, mel, valid_frames)


def encode_from_mel(
    params: dict, cfg: DolphinConfig, mel: jnp.ndarray, valid_frames: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mel features (B, T, n_mels) -> (enc, valid): CMVN, Conv2d
    subsampling with sqrt(d) embed scale, E-Branchformer stack.
    Feature-level entry shared by the audio path and the full-geometry
    parity tests."""
    mel = (mel - params["cmvn_mean"]) * params["cmvn_istd"]
    keep = length_mask(valid_frames, mel.shape[1])
    mel = jnp.where(keep[..., None], mel, 0.0)

    x = mel[..., None]
    sub = params["subsample"]
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, sub["conv0"]["w"], (2, 2), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + sub["conv0"]["b"])
    x = jax.nn.relu(jax.lax.conv_general_dilated(
        x, sub["conv1"]["w"], (2, 2), [(0, 0), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC")) + sub["conv1"]["b"])
    b, t = x.shape[0], x.shape[1]
    x = x.transpose(0, 1, 3, 2).reshape(b, t, -1)
    x = dense(x, sub["out"]) * (cfg.d_model ** 0.5)  # espnet embed xscale
    valid = ((valid_frames - 3) // 2 + 1 - 3) // 2 + 1

    pe = jnp.asarray(relative_position_embedding(t, cfg.d_model), x.dtype)
    key_mask = length_mask(valid, t)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    for p in params["enc_blocks"]:
        x = ebranchformer_block(x, p, cfg.enc_heads, pe, bias, key_mask)
    return layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"]), valid


def ctc_decode(
    params: dict, cfg: DolphinConfig, enc: jnp.ndarray, enc_valid: jnp.ndarray, blank_id: int = 0
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """CTC head over encoder output (Dolphin's fast/auxiliary head)."""
    ids = jnp.argmax(dense(enc, params["ctc"]), axis=-1).astype(jnp.int32)
    return ctc_greedy_collapse(ids, enc_valid, blank_id)


def make_state(params: dict, cfg: DolphinConfig, enc: jnp.ndarray) -> dict:
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
    pe = jnp.asarray(relative_position_embedding(cfg.max_target_positions, d))
    pos_table = pe[: cfg.max_target_positions][::-1]  # absolute positions 0..t_max-1
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
    return embedding_logits(dec["embed"], x), {"layers": tuple(new_layers)}


@functools.partial(jax.jit, static_argnames=("cfg", "decode_cfg"))
def prefill_window(
    params: dict,
    cfg: DolphinConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    prompt: jnp.ndarray,
    decode_cfg: DecodeConfig,
) -> dict[str, jnp.ndarray]:
    """Encoder + lang/region probes + prompt prefill for one window — the
    front half of :func:`transcribe`, split out so the continuous AED
    engine (``parallel/aed_batcher.py``) prefills one request
    independently of everyone else's decode steps. Returns ``state``,
    ``logits0`` (suppressed), ``enc_valid``, ``prompt`` (probe slots
    resolved) and, when the catalog is configured, ``language``/``region``."""
    enc, enc_valid = encode(params, cfg, audio, valid_samples)
    cross_bias = jnp.where(length_mask(enc_valid, enc.shape[1]), 0.0, NEG_INF)[
        :, None, None, :
    ].astype(jnp.float32)

    out: dict = {}
    if cfg.language_token_end > cfg.language_token_start:
        st = make_state(params, cfg, enc)
        sos = prompt[:, :1]
        lg, st = _decoder_pass(params, cfg, st, sos, jnp.asarray(0, jnp.int32), cross_bias)
        span_lo, span_hi = cfg.language_token_start, cfg.language_token_end
        lang = (jnp.argmax(lg[:, -1, span_lo:span_hi], axis=-1)
                + span_lo).astype(jnp.int32)
        prompt = jnp.where(prompt == -1, lang[:, None], prompt)
        if cfg.region_token_end > cfg.region_token_start:
            lg2, st = _decoder_pass(params, cfg, st, lang[:, None],
                                    jnp.asarray(1, jnp.int32), cross_bias)
            region = (jnp.argmax(lg2[:, -1, cfg.region_token_start:cfg.region_token_end],
                                 axis=-1) + cfg.region_token_start).astype(jnp.int32)
            prompt = jnp.where(prompt == -2, region[:, None], prompt)
            out["region"] = region
        out["language"] = lang

    state = make_state(params, cfg, enc)
    logits, state = _decoder_pass(params, cfg, state, prompt,
                                  jnp.asarray(0, jnp.int32), cross_bias)
    logits0 = suppress_tokens(logits[:, -1].astype(jnp.float32),
                              decode_cfg.suppress_ids)
    out.update({"state": state, "logits0": logits0, "enc_valid": enc_valid,
                "prompt": prompt, "enc": enc})
    return out


@functools.partial(jax.jit, static_argnames=("cfg", "decode_cfg"))
def transcribe(
    params: dict,
    cfg: DolphinConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    prompt: jnp.ndarray,
    decode_cfg: DecodeConfig,
    rng: jax.Array | None = None,
) -> dict:
    """Raw audio + prompt -> generated ids, with lang/region auto-detect.

    ``prompt`` (B, P) int32: [sos, lang, region, ...]; slots holding -1/-2
    are replaced by the probed language/region token (reference probe-aware
    decoder, ``Dolphin/v1/Shared_Merged.py:24-35``).
    """
    b, p_len = prompt.shape
    pre = prefill_window(params, cfg, audio, valid_samples, prompt, decode_cfg)
    enc, enc_valid = pre["enc"], pre["enc_valid"]
    state, logits0, prompt = pre["state"], pre["logits0"], pre["prompt"]
    cross_bias = jnp.where(length_mask(enc_valid, enc.shape[1]), 0.0, NEG_INF)[
        :, None, None, :
    ].astype(jnp.float32)
    out = {k: pre[k] for k in ("language", "region") if k in pre}
    t_total = p_len + decode_cfg.max_new_tokens + 1
    buf = jnp.zeros((b, t_total), jnp.int32)
    buf = jax.lax.dynamic_update_slice(buf, prompt.astype(jnp.int32), (0, 0))
    if rng is None:
        rng = jax.random.PRNGKey(0)
    first, rng = select_token(logits0, buf, jnp.asarray(p_len, jnp.int32), decode_cfg, rng,
                              history_start=p_len)

    def step(state, token, pos):
        lg, state = _decoder_pass(params, cfg, state, token, pos, cross_bias)
        return lg[:, -1], state

    tokens, counts = ar_decode(
        step, state, jnp.asarray(p_len, jnp.int32), first, buf, decode_cfg, rng
    )
    out.update({"tokens": tokens, "counts": counts})
    return out
