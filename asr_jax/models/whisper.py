"""Whisper: AR encoder-decoder with on-device KV-cache decode.

Capability parity with reference ``Whisper/Export_Whisper.py`` +
``Whisper/Inference_Whisper_ONNX.py`` (4,345 LoC): mel front-end in-graph,
encoder (2 convs + attention stack), decoder with self-KV caches and
precomputed per-layer cross-KV, language detection from the first-step
logits, no-speech probe, suppress/begin-suppress token biasing, and
greedy/penalty/sampling decode — all as ONE jitted program per phase
(probe-prefill / prefill / while-loop decode) instead of the reference's
9 merged ONNX strategy graphs + per-token session launches.

Checkpoint source: HF ``WhisperForConditionalGeneration`` weights via
``asr_jax.loaders.whisper_hf``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig, ar_decode, select_token
from asr_jax.decode.strategies import suppress_tokens
from asr_jax.quant.quantize import embedding_logits
from asr_jax.frontend.whisper_mel import WhisperMelConfig, log_mel_spectrogram
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.transformer import (
    cross_kv,
    decoder_block,
    dense,
    encoder_block,
    merge_heads,
    split_heads,
)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51866          # large-v3 / turbo
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 4          # turbo; 32 for large-v3
    num_heads: int = 20
    ffn_dim: int = 5120
    n_mels: int = 128
    max_source_positions: int = 1500
    max_target_positions: int = 448
    sample_rate: int = 16000
    # Special token ids (large-v3 family defaults; loader overwrites from
    # the checkpoint's generation config).
    sot_id: int = 50258
    eot_id: int = 50257
    no_speech_id: int = 50363
    no_timestamps_id: int = 50364
    transcribe_id: int = 50360
    translate_id: int = 50359
    first_language_id: int = 50259
    num_languages: int = 100
    # KV-cache STORAGE dtype: None = encoder compute dtype. "bfloat16"
    # halves cache HBM while compute stays f32 (attention promotes at the
    # matmul use points) — the reference's f16 cross-KV storage option
    # (``Whisper/Export_Whisper.py`` USE_FP16_KV / COMPUTE_IN_F32), with
    # bf16 instead of f16 because its exponent range needs no overflow
    # guards (SURVEY.md §7.7).
    kv_dtype: str | None = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def mel_config(self) -> WhisperMelConfig:
        return WhisperMelConfig(n_mels=self.n_mels, sample_rate=self.sample_rate)


def init_params(cfg: WhisperConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 4096))
    d, f = cfg.d_model, cfg.ffn_dim

    def lin(i, o, bias=True):
        p = {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def ln():
        return {"scale": jnp.ones((d,), dtype), "bias": jnp.zeros((d,), dtype)}

    def attn():
        return {"q": lin(d, d), "k": lin(d, d, bias=False), "v": lin(d, d), "o": lin(d, d)}

    def mlp():
        return {"fc1": lin(d, f), "fc2": lin(f, d)}

    def enc_block():
        return {"ln1": ln(), "attn": attn(), "ln2": ln(), "mlp": mlp()}

    def dec_block():
        return {"ln1": ln(), "attn": attn(), "ln_cross": ln(), "cross": attn(), "ln2": ln(), "mlp": mlp()}

    return {
        "encoder": {
            "conv1": {"w": (jax.random.normal(next(keys), (3, cfg.n_mels, d)) * 0.02).astype(dtype), "b": jnp.zeros((d,), dtype)},
            "conv2": {"w": (jax.random.normal(next(keys), (3, d, d)) * 0.02).astype(dtype), "b": jnp.zeros((d,), dtype)},
            "pos": (jax.random.normal(next(keys), (cfg.max_source_positions, d)) * 0.02).astype(dtype),
            "blocks": [enc_block() for _ in range(cfg.encoder_layers)],
            "ln_post": ln(),
        },
        "decoder": {
            "embed": (jax.random.normal(next(keys), (cfg.vocab_size, d)) * 0.02).astype(dtype),
            "pos": (jax.random.normal(next(keys), (cfg.max_target_positions, d)) * 0.02).astype(dtype),
            "blocks": [dec_block() for _ in range(cfg.decoder_layers)],
            "ln": ln(),
        },
    }


def conv1d(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray, stride: int) -> jnp.ndarray:
    """(B, T, Cin) conv with kernel (K, Cin, Cout), SAME-1 padding."""
    y = jax.lax.conv_general_dilated(
        x, w, (stride,), [(1, 1)], dimension_numbers=("NHC", "HIO", "NHC")
    )
    return y + b


def encode(params: dict, cfg: WhisperConfig, mel: jnp.ndarray) -> jnp.ndarray:
    """mel (B, T, n_mels) -> encoder states (B, T // 2, d_model)."""
    e = params["encoder"]
    mel = mel.astype(e["conv1"]["w"].dtype)  # bf16 serving: f32 mel meets cast weights
    x = jax.nn.gelu(conv1d(mel, e["conv1"]["w"], e["conv1"]["b"], 1), approximate=False)
    x = jax.nn.gelu(conv1d(x, e["conv2"]["w"], e["conv2"]["b"], 2), approximate=False)
    x = x + e["pos"][: x.shape[1]]
    for p in e["blocks"]:
        x = encoder_block(x, p, cfg.num_heads)
    return layer_norm(x, e["ln_post"]["scale"], e["ln_post"]["bias"])


def make_state(params: dict, cfg: WhisperConfig, enc: jnp.ndarray) -> dict:
    """Build decode state: precomputed cross-KV + zeroed self-KV caches.
    ``cfg.kv_dtype`` selects the cache STORAGE dtype (compute unchanged:
    attention upcasts at the matmul use points)."""
    b = enc.shape[0]
    dtype = jnp.dtype(cfg.kv_dtype) if cfg.kv_dtype else enc.dtype
    t_max = cfg.max_target_positions
    h, hd = cfg.num_heads, cfg.head_dim
    layers = []
    for p in params["decoder"]["blocks"]:
        ck, cv = cross_kv(enc, p, cfg.num_heads)
        layers.append(
            {
                "cross_k": ck.astype(dtype),
                "cross_v": cv.astype(dtype),
                "self_k": jnp.zeros((b, t_max, h, hd), dtype),
                "self_v": jnp.zeros((b, t_max, h, hd), dtype),
            }
        )
    return {"layers": tuple(layers)}


def _decoder_pass(
    params: dict, cfg: WhisperConfig, state: dict, tokens: jnp.ndarray, pos: jnp.ndarray
) -> tuple[jnp.ndarray, dict]:
    """Run S tokens through all decoder blocks at position ``pos``.

    Returns (logits (B, S, V), new state)."""
    dec = params["decoder"]
    s = tokens.shape[1]
    x = dec["embed"][tokens] + jax.lax.dynamic_slice(
        dec["pos"], (pos, 0), (s, dec["pos"].shape[1])
    )
    x = x.astype(dec["embed"].dtype)
    new_layers = []
    for p, lstate in zip(dec["blocks"], state["layers"]):
        x, nk, nv = decoder_block(
            x, p, cfg.num_heads, lstate["self_k"], lstate["self_v"], pos,
            lstate["cross_k"], lstate["cross_v"],
        )
        new_layers.append({**lstate, "self_k": nk, "self_v": nv})
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    logits = embedding_logits(dec["embed"], x)
    return logits, {"layers": tuple(new_layers)}


def prefill(
    params: dict, cfg: WhisperConfig, state: dict, tokens: jnp.ndarray
) -> tuple[jnp.ndarray, dict]:
    """Prefill the prompt. tokens (B, P) -> (last-position logits (B, V), state)."""
    logits, state = _decoder_pass(params, cfg, state, tokens, jnp.asarray(0, jnp.int32))
    return logits[:, -1], state


def step(params: dict, cfg: WhisperConfig, state: dict, token: jnp.ndarray, pos: jnp.ndarray):
    logits, state = _decoder_pass(params, cfg, state, token, pos)
    return logits[:, -1], state


def detect_language(logits_sot: jnp.ndarray, cfg: WhisperConfig) -> jnp.ndarray:
    """Language id from the first decode step after [SOT] — argmax restricted
    to the language-token block (reference probe-prefill,
    ``Whisper/Inference_Whisper_ONNX.py:793-798``)."""
    lang_block = jax.lax.dynamic_slice_in_dim(
        logits_sot, cfg.first_language_id, cfg.num_languages, axis=-1
    )
    return (jnp.argmax(lang_block, axis=-1) + cfg.first_language_id).astype(jnp.int32)


def no_speech_prob(logits_sot: jnp.ndarray, cfg: WhisperConfig) -> jnp.ndarray:
    """P(<|nospeech|>) from un-suppressed first-step logits (reference
    ``Whisper/Export_Whisper.py:334-348``)."""
    probs = jax.nn.softmax(logits_sot.astype(jnp.float32), axis=-1)
    return probs[..., cfg.no_speech_id]


@functools.partial(
    jax.jit, static_argnames=("cfg", "decode_cfg", "begin_suppress_ids"))
def prefill_window(
    params: dict,
    cfg: WhisperConfig,
    mel: jnp.ndarray,
    prompt: jnp.ndarray,
    decode_cfg: DecodeConfig,
    begin_suppress_ids: tuple[int, ...] = (),
) -> dict[str, jnp.ndarray]:
    """Encoder + [SOT] probe + prompt prefill for one window — the front
    half of :func:`transcribe_window`, split out so the continuous AED
    engine (``parallel/aed_batcher.py``) prefills one request
    independently of everyone else's decode steps.

    Returns dict: ``state`` (prefilled decode state), ``logits0`` (B, V)
    suppressed + begin-suppressed prefill logits, ``language`` (B,),
    ``no_speech_prob`` (B,).
    """
    enc = encode(params, cfg, mel)
    b = prompt.shape[0]

    # Probe: one [SOT] step for language id + no-speech prob.
    probe_state = make_state(params, cfg, enc)
    sot = jnp.full((b, 1), cfg.sot_id, jnp.int32)
    probe_logits, _ = prefill(params, cfg, probe_state, sot)
    language = detect_language(probe_logits, cfg)
    nsp = no_speech_prob(probe_logits, cfg)

    prompt = jnp.where(prompt == -1, language[:, None], prompt)

    state = make_state(params, cfg, enc)
    logits0, state = prefill(params, cfg, state, prompt)
    logits0 = suppress_tokens(logits0.astype(jnp.float32), decode_cfg.suppress_ids)
    logits0 = suppress_tokens(logits0, begin_suppress_ids)
    return {"state": state, "logits0": logits0, "language": language,
            "no_speech_prob": nsp, "prompt": prompt}


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "decode_cfg", "begin_suppress_ids"),
)
def transcribe_window(
    params: dict,
    cfg: WhisperConfig,
    mel: jnp.ndarray,
    prompt: jnp.ndarray,
    decode_cfg: DecodeConfig,
    begin_suppress_ids: tuple[int, ...] = (),
    rng: jax.Array | None = None,
) -> dict[str, jnp.ndarray]:
    """Full window pipeline: encode -> probe(SOT) -> prefill -> decode loop.

    Args:
      mel: (B, T, n_mels) log-mel features.
      prompt: (B, P) int32 full prompt, e.g. [SOT, lang, task, notimestamps];
        a lang slot of -1 is replaced by the detected language.

    Returns dict: tokens (B, T_total), counts (B,), language (B,),
    no_speech_prob (B,).
    """
    b, p_len = prompt.shape
    pre = prefill_window(params, cfg, mel, prompt, decode_cfg,
                         begin_suppress_ids=begin_suppress_ids)
    state, logits0, prompt = pre["state"], pre["logits0"], pre["prompt"]
    language, nsp = pre["language"], pre["no_speech_prob"]

    t_total = p_len + decode_cfg.max_new_tokens + 1
    buf = jnp.zeros((b, t_total), jnp.int32)
    buf = jax.lax.dynamic_update_slice(buf, prompt.astype(jnp.int32), (0, 0))
    if rng is None:
        rng = jax.random.PRNGKey(0)
    first, rng = select_token(logits0, buf, jnp.asarray(p_len, jnp.int32), decode_cfg, rng,
                              history_start=p_len)

    def step_fn(state, token, pos):
        return step(params, cfg, state, token, pos)

    tokens, counts = ar_decode(
        step_fn, state, jnp.asarray(p_len, jnp.int32), first, buf, decode_cfg, rng
    )
    return {"tokens": tokens, "counts": counts, "language": language, "no_speech_prob": nsp}


def mel_for_audio(cfg: WhisperConfig, audio: jnp.ndarray) -> jnp.ndarray:
    """(B, 480000) [-1,1] audio -> (B, 3000, n_mels)."""
    return log_mel_spectrogram(audio, cfg.mel_config())
