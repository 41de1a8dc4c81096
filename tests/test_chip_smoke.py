"""``chip_smoke.py`` off the card: it refuses a CPU-only process, and its
phases run end to end at tiny configurations on the CPU (the full-width
run needs a GPU)."""

import json

import jax
import pytest

import chip_smoke
from asr_jax.models import sensevoice as sv
from asr_jax.models import whisper as wh

TINY_SV = sv.SenseVoiceConfig(
    vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
)
TINY_WH = wh.WhisperConfig(
    vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=2,
    num_heads=4, n_mels=16, ffn_dim=48, max_source_positions=40,
    max_target_positions=48, sot_id=1, eot_id=2, first_language_id=10,
    num_languages=4, no_speech_id=30, no_timestamps_id=5, transcribe_id=6,
    translate_id=7,
)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; JAX's default device is "
                    f"{jax.devices()[0].platform}")


@pytest.mark.gpu
def test_quant_dense_decode_shape_on_gpu(gpu):
    """Phase 4's quant_dense gate at the Whisper-turbo MLP shape."""
    chip_smoke.quant_dense_check(seed=0)


def test_main_exits_nonzero_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok"' not in out
    for line in out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_serve_helper_tiny_on_cpu(tmp_path):
    """Artifact -> CLI session -> in-process HTTP server -> 2 concurrent
    requests (16 kHz mono, 48 kHz stereo); ids equal direct transcribe."""
    model_dir = chip_smoke.write_sensevoice_artifact(tmp_path / "m", TINY_SV, seed=3)
    wavs = chip_smoke.write_request_wavs(
        tmp_path, ((16000, 1, 2.0), (48000, 2, 1.5)), seed=3)
    records = chip_smoke.serve_and_compare(model_dir, wavs)
    assert [r["file"] for r in records] == [p.name for p in wavs]
    assert all(r["n_ids"] > 0 and r["latency_s"] > 0 for r in records)


def test_decode_phase_tiny_on_cpu(monkeypatch):
    """Solo q8 decode and the continuous batcher agree; quant_dense meets
    both mode gates."""
    monkeypatch.setattr(chip_smoke, "WHISPER_WINDOW_S", 0.8)
    chip_smoke.decode_phase(TINY_WH, seed=1, steps=5, n_requests=3)


def test_numerics_phase_tiny_on_cpu():
    chip_smoke.numerics_phase(TINY_SV, seed=2)
