"""In-graph audio front-ends (L1 of SURVEY.md §1), static shapes."""

from asr_jax.frontend.framing import frame_signal, num_frames_snip, pad_basis_to_blocks
from asr_jax.frontend.kaldi_fbank import KaldiFbankConfig, log_mel_fbank
from asr_jax.frontend.lfr import apply_cmvn_addmul, lfr_out_len, lfr_stack
from asr_jax.frontend.mel_banks import kaldi_mel_banks, slaney_mel_banks
from asr_jax.frontend.whisper_mel import WhisperMelConfig, log_mel_spectrogram

__all__ = [
    "frame_signal",
    "num_frames_snip",
    "pad_basis_to_blocks",
    "KaldiFbankConfig",
    "log_mel_fbank",
    "apply_cmvn_addmul",
    "lfr_out_len",
    "lfr_stack",
    "kaldi_mel_banks",
    "slaney_mel_banks",
    "WhisperMelConfig",
    "log_mel_spectrogram",
]
