"""Fun-ASR-Nano: SANM encoder + dual decode heads (fast CTC / Qwen3 LLM).

Capability parity with reference ``Fun_ASR_Nano/Export_Fun_ASR_Nano.py`` +
``Inference_Fun_ASR_Nano_ONNX.py`` (5,714 LoC): Kaldi fbank scaled by
sqrt(encoder_size) (no CMVN), truncating LFR length ``frames // 6 - 1``,
SenseVoice-style SANM encoder (encoders0/encoders/tp_encoders), then
either
  (a) the **fast CTC head**: transformer ctc_decoder (linear1 -> relu ->
      linear2 -> MHA blocks) + CTC projection + greedy collapse, or
  (b) the **LLM path**: audio_adaptor (linear1/relu/linear2 + MHA blocks,
      output truncated to ``ceil(mel_frames / 48)`` speech tokens — the
      checkpoint's training-time ``fake_token_len`` convention,
      ``Export_Fun_ASR_Nano.py:805-816``) feeding a Qwen3-style decoder
      with the [head | query | audio | tail] prompt layout and
      greedy/penalty/sampling decode.

The Qwen3 decoder machinery is shared with Qwen3-ASR
(``asr_jax.layers.qwen3``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig
from asr_jax.decode.ctc import ctc_greedy_collapse
from asr_jax.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_jax.frontend.lfr import lfr_stack
from asr_jax.layers import qwen3
from asr_jax.layers.attention import NEG_INF, length_mask
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import sanm_block
from asr_jax.layers.transformer import dense, merge_heads, mha, split_heads
from asr_jax.models.qwen_asr import assemble_prompt, transcribe_embeds
from asr_jax.models.sensevoice import sinusoid_position_encoding


@dataclasses.dataclass(frozen=True)
class FunAsrNanoConfig:
    # SANM audio encoder.
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
    # Adaptor / CTC decoder (transformer blocks on top of the encoder).
    adaptor_hidden: int = 1024       # llm hidden
    adaptor_blocks: int = 2
    adaptor_heads: int = 8
    adaptor_ffn: int = 4096
    ctc_hidden: int = 512
    ctc_blocks: int = 2
    ctc_heads: int = 4
    ctc_ffn: int = 2048
    ctc_vocab: int = 8404
    blank_id: int = 0
    llm: qwen3.Qwen3Config = qwen3.Qwen3Config()
    eot_id: int = 151645
    sample_rate: int = 16000
    fbank: KaldiFbankConfig = KaldiFbankConfig()

    @property
    def feature_size(self) -> int:
        return self.n_mels * self.lfr_m


def _mha_block_params(keys, in_dim, heads, head_dim, ffn, dtype):
    d = heads * head_dim

    def lin(i, o):
        return {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype),
                "b": jnp.zeros((o,), dtype)}

    return {
        "norm1": {"scale": jnp.ones((in_dim,), dtype), "bias": jnp.zeros((in_dim,), dtype)},
        "qkv": lin(in_dim, 3 * d),
        "out": lin(d, in_dim),
        "norm2": {"scale": jnp.ones((in_dim,), dtype), "bias": jnp.zeros((in_dim,), dtype)},
        "ffn": {"w1": lin(in_dim, ffn), "w2": lin(ffn, in_dim)},
    }


def init_params(cfg: FunAsrNanoConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 8192))
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

    fs = cfg.feature_size
    ad = cfg.adaptor_hidden
    return {
        "encoders0": [enc_block(fs) for _ in range(cfg.num_encoders0)],
        "encoders": [enc_block(h) for _ in range(cfg.num_encoders)],
        "tp_encoders": [enc_block(h) for _ in range(cfg.num_tp_encoders)],
        "after_norm": norm(),
        "tp_norm": norm(),
        "adaptor": {
            "linear1": lin(h, ad),
            "linear2": lin(ad, ad),
            "blocks": [
                _mha_block_params(keys, ad, cfg.adaptor_heads, ad // cfg.adaptor_heads, cfg.adaptor_ffn, dtype)
                for _ in range(cfg.adaptor_blocks)
            ],
        },
        "ctc": {
            "linear1": lin(h, cfg.ctc_hidden),
            "linear2": lin(cfg.ctc_hidden, cfg.ctc_hidden),
            "blocks": [
                _mha_block_params(keys, cfg.ctc_hidden, cfg.ctc_heads, cfg.ctc_hidden // cfg.ctc_heads, cfg.ctc_ffn, dtype)
                for _ in range(cfg.ctc_blocks)
            ],
            "lo": lin(cfg.ctc_hidden, cfg.ctc_vocab),
        },
    }


def _adaptor_block(x, p, heads, bias):
    y = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"])
    qkv = dense(y, p["qkv"])
    q, k, v = jnp.split(qkv, 3, axis=-1)
    ctx = mha(split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), bias=bias)
    x = x + dense(merge_heads(ctx), p["out"])
    y = layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"])
    return x + dense(jax.nn.gelu(dense(y, p["ffn"]["w1"]), approximate=False), p["ffn"]["w2"])


def encode(params: dict, cfg: FunAsrNanoConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray):
    """Raw audio (B, S) int16-range -> (enc_normed (B, T_lfr, hidden),
    valid_lfr, valid_frames)."""
    fb = cfg.fbank
    n_frames = fb.num_frames(audio.shape[-1])
    mel = log_mel_fbank(audio, fb, n_frames) * (cfg.hidden ** 0.5)
    valid_frames = jnp.maximum((valid_samples - fb.win_length) // fb.hop_length + 1, 0).astype(jnp.int32)
    feats = lfr_stack(mel, cfg.lfr_m, cfg.lfr_n, valid_frames)
    # Truncating LFR length: frames // lfr_n - 1 (reference Export:774-776).
    valid_lfr = jnp.maximum(valid_frames // cfg.lfr_n - 1, 0)
    t_lfr = feats.shape[1]
    pe = jnp.asarray(sinusoid_position_encoding(t_lfr, cfg.feature_size))
    x = feats + pe[None]

    key_mask = length_mask(valid_lfr, t_lfr)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    x = jnp.where(key_mask[..., None], x, 0)
    for p in params["encoders0"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=False)
    for p in params["encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    x = layer_norm(x, params["after_norm"]["scale"], params["after_norm"]["bias"])
    for p in params["tp_encoders"]:
        x = sanm_block(x, p, cfg.num_heads, cfg.head_dim, bias, key_mask, residual=True)
    enc_normed = layer_norm(x, params["tp_norm"]["scale"], params["tp_norm"]["bias"])
    return enc_normed, valid_lfr, valid_frames


def ctc_logits(
    params: dict, cfg: FunAsrNanoConfig, enc: jnp.ndarray, valid_lfr: jnp.ndarray
) -> jnp.ndarray:
    """CTC head over encoder output -> logits (B, T_lfr, ctc_vocab).
    Split from :func:`forward_ctc` so stage probes snapshot the exact
    pre-argmax head output."""
    p = params["ctc"]
    c = dense(jax.nn.relu(dense(enc, p["linear1"])), p["linear2"])
    t = c.shape[1]
    key_mask = length_mask(valid_lfr, t)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    for bp in p["blocks"]:
        c = _adaptor_block(c, bp, cfg.ctc_heads, bias)
    return dense(c, p["lo"])


@functools.partial(jax.jit, static_argnames=("cfg",))
def forward_ctc(
    params: dict, cfg: FunAsrNanoConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fast CTC path: raw audio -> compacted token ids + counts."""
    enc, valid_lfr, _ = encode(params, cfg, audio, valid_samples)
    ids = jnp.argmax(ctc_logits(params, cfg, enc, valid_lfr), axis=-1).astype(jnp.int32)
    return ctc_greedy_collapse(ids, valid_lfr, cfg.blank_id)


def audio_embeds(params: dict, cfg: FunAsrNanoConfig, audio: jnp.ndarray, valid_samples: jnp.ndarray):
    """LLM path audio tokens: adaptor output truncated to ceil(mel/48)."""
    enc, valid_lfr, valid_frames = encode(params, cfg, audio, valid_samples)
    p = params["adaptor"]
    x = dense(jax.nn.relu(dense(enc, p["linear1"])), p["linear2"])
    t = x.shape[1]
    key_mask = length_mask(valid_lfr, t)
    bias = jnp.where(key_mask, 0.0, NEG_INF)[:, None, None, :].astype(jnp.float32)
    for bp in p["blocks"]:
        x = _adaptor_block(x, bp, cfg.adaptor_heads, bias)
    speech_tokens = (valid_frames + cfg.lfr_n * 8 - 1) // (cfg.lfr_n * 8)
    return x, speech_tokens.astype(jnp.int32)


def prompt_embeds_llm(
    params: dict,
    llm_params: dict,
    cfg: FunAsrNanoConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    prompt_ids: dict,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Front half of :func:`forward_llm`: audio + prompt ids -> compacted
    prompt embeds (B, L, H) + valid lengths, for the continuous-batching
    server (``parallel/llm_server.py``)."""
    tokens, speech_len = audio_embeds(params, cfg, audio, valid_samples)
    emb = lambda ids: llm_params["embed"][ids].astype(tokens.dtype)
    empty = jnp.zeros((tokens.shape[0], 0, tokens.shape[-1]), tokens.dtype)
    return assemble_prompt(
        emb(prompt_ids["head"]), emb(prompt_ids["query"]), empty,
        tokens, speech_len, emb(prompt_ids["tail"]),
    )


def forward_llm(
    params: dict,
    llm_params: dict,
    cfg: FunAsrNanoConfig,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    prompt_ids: dict,
    decode_cfg: DecodeConfig,
    rng: jax.Array | None = None,
):
    """LLM path: audio (B, S) + prompt ids -> generated token ids.

    ``prompt_ids``: {"head": (B, Lh), "query": (B, Lq), "tail": (B, Lt)}.
    Reuses the Qwen3-ASR prompt assembly / decode machinery (batched,
    left-padded lockstep decode — unequal audio durations are exact).
    """
    from asr_jax.models.qwen_asr import QwenAsrConfig

    embeds, valid_len = prompt_embeds_llm(
        params, llm_params, cfg, audio, valid_samples, prompt_ids)
    qcfg = QwenAsrConfig(llm=cfg.llm, eot_id=cfg.eot_id)
    return transcribe_embeds(llm_params, qcfg, embeds, valid_len, decode_cfg, rng)
