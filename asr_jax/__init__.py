"""asr_jax — multi-family ASR framework in JAX/XLA.

A from-scratch rebuild of the capabilities of
DakeQQ/Automatic-Speech-Recognition-ASR-ONNX as an idiomatic JAX stack:

- ``asr_jax.frontend``  — in-graph audio DSP (Kaldi fbank, Whisper STFT-mel,
  LFR, CMVN) expressed as framed matmuls.
- ``asr_jax.layers``    — encoder/decoder building blocks (SANM, Conformer,
  E-Branchformer, Zipformer, GQA+RoPE decoder layers, LSTM).
- ``asr_jax.decode``    — on-device decode loops (CTC collapse, AR
  greedy/penalty/sampling with KV cache, CIF, TDT, RNN-T) as
  ``lax.scan`` / ``lax.while_loop`` programs with fixed shapes.
- ``asr_jax.models``    — the 12 model families.
- ``asr_jax.loaders``   — checkpoint ingestion (safetensors/HF/FunASR/...)
  directly into JAX pytrees (replaces the reference's Export+Optimize ONNX
  pipeline entirely).
- ``asr_jax.runtime``   — audio ingest, tokenizers, metadata contract,
  sessions, sliding windows, RTF reporting.
- ``asr_jax.parallel``  — ``jax.sharding`` meshes (batch-DP / TP) for
  multi-device serving and training.
- ``asr_jax.ops``       — the quantized-weight dense layer.
- ``asr_jax.quant``     — int8/int4 weight-only quantization with fused
  dequant matmuls.

The reference's five layers (SURVEY.md §1) map as: L1 -> frontend/ops,
L2 -> models+layers, L3+L4 (ONNX graph surgery + quantization) collapse into
"load checkpoint into one pytree and let XLA fuse" plus quant/,
L5 -> runtime+decode.
"""

__version__ = "0.1.0"
