"""Zipformer2 streaming transducer (X-ASR, icefall).

Capability parity with reference ``X-ASR/Export_X_ASR.py`` (1,537 LoC):
6-stage U-Net encoder (downsampling 1/2/4/8/4/2, 19 layers), per layer:
shared rel-pos attention weights feeding nonlin-attention + two
self-attentions, three SwooshL feed-forwards, two chunk-causal depthwise
conv modules (SwooshR), per-channel bypasses and a BiasNorm+bypass output;
Conv2dSubsampling front (SwooshR convs + cached-left-pad ConvNeXt block);
stateless context-2 decoder + joiner with in-graph argmax; Kaldi
povey-window fbank with snip_edges=False reflection padding.

Streaming state: 6 caches per layer (attention key, nonlin-attention,
2x value, 2x conv) + the ConvNeXt left pad + processed_lens — the
reference threads 116 ONNX tensors; here it is one pytree.

Geometry-baked parameters (matching the reference's own export-time
baking, ``Export_X_ASR.py:282-376``): the projected relative-position
tables (``pos_table``) and the fused causal+chunkwise depthwise conv maps
(``fused_w/fused_b``) are precomputed per fixed chunk geometry by the
loader; random init generates them directly.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_jax.layers.transformer import dense


def swoosh_l(x):
    return jax.nn.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x):
    return jax.nn.softplus(x - 1.0) - 0.08 * x - 0.313261687


def bias_norm(x, bias, log_scale):
    """icefall BiasNorm: x * exp(log_scale) * sqrt(D) / ||x - bias||_2."""
    d = x.shape[-1]
    norm = jnp.sqrt(jnp.sum(jnp.square(x - bias), axis=-1, keepdims=True))
    return x * (jnp.exp(log_scale) * (d ** 0.5) / jnp.maximum(norm, 1e-9))


@dataclasses.dataclass(frozen=True)
class ZipformerConfig:
    vocab_size: int = 5000
    feature_dim: int = 80
    downsampling_factor: tuple = (1, 2, 4, 8, 4, 2)
    num_encoder_layers: tuple = (2, 2, 4, 5, 4, 2)
    encoder_dim: tuple = (192, 256, 512, 768, 512, 256)
    query_head_dim: tuple = (32,) * 6
    pos_head_dim: tuple = (4,) * 6
    value_head_dim: tuple = (12,) * 6
    num_heads: tuple = (4, 4, 4, 8, 4, 4)
    feedforward_dim: tuple = (512, 768, 1536, 2048, 1536, 768)
    cnn_module_kernel: tuple = (31, 31, 15, 15, 15, 31)
    nonlin_hidden: tuple = (576, 768, 1536, 2304, 1536, 768)  # 3 * dim // 4 * 4? loader-set
    output_downsampling_factor: int = 2
    chunk_size: int = 8                  # encoder frames (50 Hz) per chunk
    left_context_frames: int = 96
    # Subsampling / ConvNeXt geometry.
    sub_layer1: int = 8
    sub_layer2: int = 32
    sub_layer3: int = 128
    convnext_pad_time: int = 3
    convnext_pad_freq: int = 3
    # Transducer.
    decoder_dim: int = 512
    joiner_dim: int = 512
    context_size: int = 2
    decoder_conv_groups: int = 128   # icefall Decoder: groups = decoder_dim // 4
    blank_id: int = 0
    max_symbols_per_frame: int = 1
    fbank: KaldiFbankConfig = KaldiFbankConfig(window="povey")

    @property
    def mel_per_chunk(self) -> int:
        # Conv2dSubsampling consumes T = 2*chunk + 13 mel frames per window.
        return self.chunk_size * 2 + 13

    @property
    def window_samples(self) -> int:
        fb = self.fbank
        return (self.mel_per_chunk - 1) * fb.hop_length + fb.win_length

    @property
    def advance_samples(self) -> int:
        return self.chunk_size * 2 * self.fbank.hop_length

    @property
    def num_stacks(self) -> int:
        return len(self.downsampling_factor)

    def stack_geom(self, s: int) -> dict:
        ds = self.downsampling_factor[s]
        seq = self.chunk_size // ds
        left = self.left_context_frames // ds
        return {
            "ds": ds, "seq": seq, "left": left, "k_len": seq + left,
            "seq_len2": 2 * seq - 1 + left,
            "heads": self.num_heads[s], "qhd": self.query_head_dim[s],
            "phd": self.pos_head_dim[s], "vhd": self.value_head_dim[s],
            "dim": self.encoder_dim[s], "ffn": self.feedforward_dim[s],
            "kernel": self.cnn_module_kernel[s],
            "hidden": 3 * self.encoder_dim[s] // 4,
        }

    @property
    def output_dim(self) -> int:
        return max(self.encoder_dim)


def init_params(cfg: ZipformerConfig, rng: jax.Array, dtype=jnp.float32) -> dict:
    keys = iter(jax.random.split(rng, 16384))

    def lin(i, o, bias=True, scale=None):
        s = scale if scale is not None else i ** -0.5
        p = {"w": (jax.random.normal(next(keys), (i, o)) * s).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def layer(g):
        d, h, qhd, phd, vhd = g["dim"], g["heads"], g["qhd"], g["phd"], g["vhd"]
        return {
            "attn_in_proj": lin(d, 2 * h * qhd + h * phd),
            "pos_table": (jax.random.normal(next(keys), (h, phd, g["seq_len2"])) * 0.5).astype(dtype),
            "ff1": {"in": lin(d, g["ffn"] * 3 // 4), "out": lin(g["ffn"] * 3 // 4, d)},
            "ff2": {"in": lin(d, g["ffn"]), "out": lin(g["ffn"], d)},
            "ff3": {"in": lin(d, g["ffn"] * 5 // 4), "out": lin(g["ffn"] * 5 // 4, d)},
            "nonlin": {"in": lin(d, 3 * g["hidden"]), "out": lin(g["hidden"], d)},
            "sa1": {"in": lin(d, h * vhd), "out": lin(h * vhd, d)},
            "sa2": {"in": lin(d, h * vhd), "out": lin(h * vhd, d)},
            "conv1": _conv_params(keys, g, dtype),
            "conv2": _conv_params(keys, g, dtype),
            "bypass_mid": jnp.full((d,), 0.5, dtype),
            "bypass": jnp.full((d,), 0.5, dtype),
            "norm_bias": jnp.zeros((d,), dtype),
            "norm_log_scale": jnp.zeros((), dtype),
        }

    def _conv_params(keys, g, dtype):
        d, seq = g["dim"], g["seq"]
        left_pad = g["kernel"] // 2
        return {
            "in": lin(d, 2 * d),
            "fused_w": (jax.random.normal(next(keys), (d, seq, left_pad + seq)) * (g["kernel"] ** -0.5)).astype(dtype),
            "fused_b": jnp.zeros((d, seq), dtype),
            "out": lin(d, d),
        }

    stacks = []
    for s in range(cfg.num_stacks):
        g = cfg.stack_geom(s)
        stack = {"layers": [layer(g) for _ in range(cfg.num_encoder_layers[s])]}
        if g["ds"] != 1:
            stack["downsample_w"] = jnp.full((g["ds"],), 1.0 / g["ds"], dtype)
            stack["out_combiner"] = jnp.full((g["dim"],), 0.5, dtype)
        stacks.append(stack)

    l1, l2, l3 = cfg.sub_layer1, cfg.sub_layer2, cfg.sub_layer3
    out_width = (((cfg.feature_dim + 2 - 2) - 3) // 2 + 1 - 3) // 2 + 1  # 19 for 80 mels
    return {
        "embed": {
            "conv0": {"w": (jax.random.normal(next(keys), (3, 3, 1, l1)) * 0.3).astype(dtype), "b": jnp.zeros((l1,), dtype)},
            "conv1": {"w": (jax.random.normal(next(keys), (3, 3, l1, l2)) * 0.1).astype(dtype), "b": jnp.zeros((l2,), dtype)},
            "conv2": {"w": (jax.random.normal(next(keys), (3, 3, l2, l3)) * 0.05).astype(dtype), "b": jnp.zeros((l3,), dtype)},
            "convnext": {
                "dw": {"w": (jax.random.normal(next(keys), (7, 7, 1, l3)) * 0.05).astype(dtype), "b": jnp.zeros((l3,), dtype)},
                "pw1": lin(l3, 3 * l3),
                "pw2": {"w": (jax.random.normal(next(keys), (1, 1, 3 * l3, l3)) * 0.05).astype(dtype), "b": jnp.zeros((l3,), dtype)},
            },
            "out": lin(l3 * out_width, cfg.encoder_dim[0]),
            "out_norm_bias": jnp.zeros((cfg.encoder_dim[0],), dtype),
            "out_norm_log_scale": jnp.zeros((), dtype),
        },
        "stacks": stacks,
        "output_ds_w": jnp.full((cfg.output_downsampling_factor,), 1.0 / cfg.output_downsampling_factor, dtype),
        "encoder_proj": lin(cfg.output_dim, cfg.joiner_dim),
        "decoder": {
            "embed": (jax.random.normal(next(keys), (cfg.vocab_size, cfg.decoder_dim)) * 0.02).astype(dtype),
            # grouped context conv (torch layout: (out, in_per_group, ctx))
            "conv_w": (jax.random.normal(
                next(keys), (cfg.decoder_dim, cfg.decoder_dim // cfg.decoder_conv_groups, cfg.context_size)
            ) * 0.1).astype(dtype),
            "proj": lin(cfg.decoder_dim, cfg.joiner_dim),
        },
        "joiner": {"out": lin(cfg.joiner_dim, cfg.vocab_size)},
    }


def init_state(cfg: ZipformerConfig, dtype=jnp.float32) -> dict:
    stacks = []
    for s in range(cfg.num_stacks):
        g = cfg.stack_geom(s)
        layers = []
        for _ in range(cfg.num_encoder_layers[s]):
            layers.append({
                "key": jnp.zeros((g["left"], g["heads"] * g["qhd"]), dtype),
                "nonlin": jnp.zeros((g["left"], g["hidden"]), dtype),
                "val1": jnp.zeros((g["left"], g["heads"] * g["vhd"]), dtype),
                "val2": jnp.zeros((g["left"], g["heads"] * g["vhd"]), dtype),
                "conv1": jnp.zeros((g["kernel"] // 2, g["dim"]), dtype),
                "conv2": jnp.zeros((g["kernel"] // 2, g["dim"]), dtype),
            })
        stacks.append(layers)
    out_width = ((((cfg.feature_dim + 2) - 2) - 3) // 2 + 1 - 3) // 2 + 1  # 19 for 80 mels
    return {
        "stacks": stacks,
        "embed_pad": jnp.zeros((cfg.convnext_pad_time, out_width, cfg.sub_layer3), dtype),
        "processed_lens": jnp.asarray(0, jnp.int32),
        # Transducer continuation (context-2 stateless decoder).
        "context": jnp.full((cfg.context_size,), -1, jnp.int32),
    }


def _subsample(params: dict, cfg: ZipformerConfig, mel: jnp.ndarray, embed_pad: jnp.ndarray):
    """(T_mel, 80) mel -> ((chunk, dim0), new ConvNeXt left pad)."""
    e = params["embed"]
    x = mel[None, :, :, None]  # NHWC: H=time, W=mel
    x = jax.lax.conv_general_dilated(x, e["conv0"]["w"], (1, 1), [(0, 0), (1, 1)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + e["conv0"]["b"]
    x = swoosh_r(x)
    x = jax.lax.conv_general_dilated(x, e["conv1"]["w"], (2, 2), [(0, 0), (0, 0)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + e["conv1"]["b"]
    x = swoosh_r(x)
    x = jax.lax.conv_general_dilated(x, e["conv2"]["w"], (1, 2), [(0, 0), (0, 0)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + e["conv2"]["b"]
    x = swoosh_r(x)  # (1, T', 19, 128)
    t_keep = cfg.chunk_size
    bypass = x[:, :t_keep]
    x = jnp.concatenate([embed_pad[None], x], axis=1)  # prepend cached time pad
    new_pad = x[0, t_keep : t_keep + cfg.convnext_pad_time]
    cx = e["convnext"]
    y = jax.lax.conv_general_dilated(
        x, cx["dw"]["w"], (1, 1), [(0, 0), (cfg.convnext_pad_freq, cfg.convnext_pad_freq)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=cfg.sub_layer3,
    ) + cx["dw"]["b"]
    y = dense(y, cx["pw1"])
    y = swoosh_l(y)
    y = jax.lax.conv_general_dilated(y, cx["pw2"]["w"], (1, 1), [(0, 0), (0, 0)],
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + cx["pw2"]["b"]
    x = bypass + y[:, :t_keep]
    t = x.shape[1]
    x = x.transpose(0, 1, 3, 2).reshape(t, -1)  # channel-major flatten (torch parity)
    x = dense(x, e["out"])
    return bias_norm(x, e["out_norm_bias"], e["out_norm_log_scale"]), new_pad


def _attn_weights(p: dict, g: dict, src: jnp.ndarray, cached_key: jnp.ndarray, kpm: jnp.ndarray):
    """Shared attention weights: (heads, seq, k_len) probs + new key cache."""
    h, qhd, phd = g["heads"], g["qhd"], g["phd"]
    seq, left, k_len = g["seq"], g["left"], g["k_len"]
    qdim = h * qhd
    proj = dense(src, p["attn_in_proj"])
    q, k, pos_q = jnp.split(proj, [qdim, 2 * qdim], axis=-1)
    k_full = jnp.concatenate([cached_key, k], axis=0)  # (k_len, qdim)
    new_key = k_full[-left:]
    qh = q.reshape(seq, h, qhd).transpose(1, 0, 2)
    kh = k_full.reshape(k_len, h, qhd).transpose(1, 2, 0)
    ph = pos_q.reshape(seq, h, phd).transpose(1, 0, 2)
    scores = jnp.einsum("hsd,hdk->hsk", qh, kh)
    pos_scores_full = jnp.einsum("hsd,hdp->hsp", ph, p["pos_table"])  # (h, seq, seq_len2)
    # rel->abs shift: row t wants columns [seq-1-t, seq-1-t+k_len) — a
    # CONTIGUOUS slice per row, so seq static slices (copies, fused by
    # XLA) instead of a general gather; gathers on small tensors are
    # latency-bound and this runs once per layer per chunk.
    pos_scores = jnp.stack(
        [pos_scores_full[:, t, seq - 1 - t: seq - 1 - t + k_len]
         for t in range(seq)], axis=1)
    scores = scores + pos_scores
    scores = jnp.where(kpm[None, None, :], -1000.0, scores)
    return jax.nn.softmax(scores, axis=-1), new_key


def _self_attn(p: dict, g: dict, src, weights, cached_val):
    h, vhd, seq, left, k_len = g["heads"], g["vhd"], g["seq"], g["left"], g["k_len"]
    v = dense(src, p["in"])
    v_full = jnp.concatenate([cached_val, v], axis=0)
    new_val = v_full[-left:]
    vh = v_full.reshape(k_len, h, vhd).transpose(1, 0, 2)
    x = jnp.einsum("hsk,hkd->hsd", weights, vh)
    x = x.transpose(1, 0, 2).reshape(seq, h * vhd)
    return dense(x, p["out"]), new_val


def _nonlin_attn(p: dict, g: dict, src, weights0, cached_x):
    hidden, seq, left = g["hidden"], g["seq"], g["left"]
    proj = dense(src, p["in"])
    s, x, y = jnp.split(proj, 3, axis=-1)
    x = x * jnp.tanh(s)
    x_full = jnp.concatenate([cached_x, x], axis=0)  # (left+seq, hidden)
    new_cached = x_full[-left:]
    x = jnp.einsum("sk,kd->sd", weights0, x_full)
    return dense(x * y, p["out"]), new_cached


def _conv_module(p: dict, g: dict, src, cache):
    d, seq = g["dim"], g["seq"]
    left_pad = g["kernel"] // 2
    proj = dense(src, p["in"])
    x, s = jnp.split(proj, 2, axis=-1)
    x = x * jax.nn.sigmoid(s)  # (seq, d)
    x_full = jnp.concatenate([cache, x], axis=0)  # (left_pad + seq, d)
    new_cache = x_full[-left_pad:]
    # Fused per-timestep linear map: out[t, c] = sum_k fused_w[c, t, k] * x_full[k, c]
    y = jnp.einsum("ctk,kc->tc", p["fused_w"], x_full) + p["fused_b"].T
    y = swoosh_r(y)
    return dense(y, p["out"]), new_cache


def _ff(p: dict, x):
    h = swoosh_l(dense(x, p["in"]))
    return dense(h, p["out"])


def _layer(p: dict, g: dict, src, lstate, kpm):
    src_orig = src
    weights, new_key = _attn_weights(p, g, src, lstate["key"], kpm)
    src = src + _ff(p["ff1"], src)
    na, new_nonlin = _nonlin_attn(p["nonlin"], g, src, weights[0], lstate["nonlin"])
    src = src + na
    sa, new_val1 = _self_attn(p["sa1"], g, src, weights, lstate["val1"])
    src = src + sa
    sc, new_conv1 = _conv_module(p["conv1"], g, src, lstate["conv1"])
    src = src + sc
    src = src + _ff(p["ff2"], src)
    src = src_orig + (src - src_orig) * p["bypass_mid"]
    src_mid = src
    sa, new_val2 = _self_attn(p["sa2"], g, src, weights, lstate["val2"])
    src = src + sa
    sc, new_conv2 = _conv_module(p["conv2"], g, src, lstate["conv2"])
    src = src + sc
    src = src + _ff(p["ff3"], src)
    # BiasNorm + output bypass (reference folds both into one expression).
    normed = bias_norm(src, p["norm_bias"], p["norm_log_scale"])
    src = src_orig + (normed - src_orig) * p["bypass"]
    new_state = {"key": new_key, "nonlin": new_nonlin, "val1": new_val1,
                 "val2": new_val2, "conv1": new_conv1, "conv2": new_conv2}
    return src, new_state


def _stack(params_s: dict, cfg: ZipformerConfig, s: int, x, states, kpm):
    g = cfg.stack_geom(s)
    ds = g["ds"]
    if ds != 1:
        kpm_s = kpm[::ds]
        src_orig = x
        xd = x.reshape(g["seq"], ds, -1)
        x = jnp.sum(xd * jax.nn.softmax(params_s["downsample_w"])[None, :, None], axis=1)
    else:
        kpm_s = kpm
    new_states = []
    for p, lst in zip(params_s["layers"], states):
        x, ns = _layer(p, g, x, lst, kpm_s)
        new_states.append(ns)
    if ds != 1:
        x = jnp.repeat(x, ds, axis=0)
        x = src_orig + (x - src_orig) * params_s["out_combiner"]
    return x, new_states


def _convert_channels(x, target):
    cur = x.shape[-1]
    if target == cur:
        return x
    if target < cur:
        return x[..., :target]
    return jnp.pad(x, ((0, 0), (0, target - cur)))


@functools.partial(jax.jit, static_argnames=("cfg",))
def encoder_step(params: dict, cfg: ZipformerConfig, state: dict, window: jnp.ndarray):
    """One audio window (window_samples,) int16-range -> (state',
    enc_out (chunk // output_ds, joiner_dim))."""
    mel = log_mel_fbank(window[None], cfg.fbank, cfg.mel_per_chunk)[0]
    x, new_pad = _subsample(params, cfg, mel, state["embed_pad"])

    # Padding mask over [left_context | chunk]: left slots not yet seen.
    thresh = jnp.concatenate([
        jnp.arange(cfg.left_context_frames - 1, -1, -1, dtype=jnp.int32),
        jnp.full((cfg.chunk_size,), -1, jnp.int32),
    ])
    kpm = state["processed_lens"] <= thresh  # True = masked
    new_processed = state["processed_lens"] + cfg.chunk_size

    outputs = []
    new_stack_states = []
    for s in range(cfg.num_stacks):
        x = _convert_channels(x, cfg.encoder_dim[s])
        x, ns = _stack(params["stacks"][s], cfg, s, x, state["stacks"][s], kpm)
        outputs.append(x)
        new_stack_states.append(ns)

    # Full-dim combine: take each channel range from the most recent stack having it.
    dims = list(cfg.encoder_dim)
    pieces = [outputs[-1]]
    cur = dims[-1]
    for i in range(cfg.num_stacks - 2, -1, -1):
        if dims[i] > cur:
            pieces.append(outputs[i][..., cur : dims[i]])
            cur = dims[i]
    full = jnp.concatenate(pieces, axis=-1)  # (chunk, output_dim)

    ds = cfg.output_downsampling_factor
    w = jax.nn.softmax(params["output_ds_w"])
    xd = full.reshape(cfg.chunk_size // ds, ds, -1)
    out = jnp.sum(xd * w[None, :, None], axis=1)
    enc = dense(out, params["encoder_proj"])

    new_state = {
        **state,
        "stacks": new_stack_states,
        "embed_pad": new_pad,
        "processed_lens": new_processed,
    }
    return new_state, enc


def decoder_out(params: dict, cfg: ZipformerConfig, context: jnp.ndarray) -> jnp.ndarray:
    """Stateless context-2 decoder -> joiner-space vector (joiner_dim,).
    Negative (startup) ids map to a zero embedding row; the context conv is
    the icefall grouped Conv1d (groups = decoder_dim // 4, no bias)."""
    dec = params["decoder"]
    safe = jnp.maximum(context, 0)
    emb = dec["embed"][safe] * (context >= 0)[:, None]  # (ctx, D)
    groups = cfg.decoder_conv_groups
    in_per = cfg.decoder_dim // groups
    out_per = cfg.decoder_dim // groups
    # emb (ctx, D) -> (ctx, groups, in_per); w (D, in_per, ctx) -> (groups, out_per, in_per, ctx)
    e = emb.reshape(cfg.context_size, groups, in_per)
    w = dec["conv_w"].reshape(groups, out_per, in_per, cfg.context_size)
    y = jnp.einsum("goik,kgi->go", w, e).reshape(cfg.decoder_dim)
    y = jax.nn.relu(y)
    return dense(y, dec["proj"])


@functools.partial(jax.jit, static_argnames=("cfg", "max_new"))
def greedy_chunk(params: dict, cfg: ZipformerConfig, state: dict, enc: jnp.ndarray, max_new: int = 8):
    """Greedy transducer over this chunk's frames (max 1 symbol per frame,
    reference ``Inference_X_ASR_ONNX.py:418-433``).

    Returns (state' with updated context, ids (max_new,), count)."""
    t = enc.shape[0]

    def body(carry, frame):
        context, buf, count = carry
        d = decoder_out(params, cfg, context)
        logits = jnp.dot(jnp.tanh(frame + d), params["joiner"]["out"]["w"]) + params["joiner"]["out"]["b"]
        tok = jnp.argmax(logits).astype(jnp.int32)
        emit = tok != cfg.blank_id
        new_context = jnp.where(emit, jnp.concatenate([context[1:], tok[None]]), context)
        buf = buf.at[jnp.where(emit & (count < max_new), count, max_new)].set(tok, mode="drop")
        count = count + (emit & (count < max_new)).astype(jnp.int32)
        return (new_context, buf, count), None

    init = (state["context"], jnp.zeros((max_new + 1,), jnp.int32), jnp.asarray(0, jnp.int32))
    (context, buf, count), _ = jax.lax.scan(body, init, enc)
    return {**state, "context": context}, buf[:max_new], count


@functools.partial(jax.jit, static_argnames=("cfg", "max_new"))
def transcribe_chunk(params: dict, cfg: ZipformerConfig, state: dict, window: jnp.ndarray, max_new: int = 8):
    """Fused encoder_step + greedy_chunk (one device dispatch per chunk —
    the reference needs 1 encoder + per-frame joiner ORT launches)."""
    state, enc = encoder_step.__wrapped__(params, cfg, state, window)
    return greedy_chunk.__wrapped__(params, cfg, state, enc, max_new)
