"""CLI: artifact inspect / quantize / transcribe round trip."""

import json
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.cli import main
from asr_jax.models import sensevoice as sv
from asr_jax.runtime.artifact import save_model
from asr_jax.runtime.metadata import ModelMetadata

TINY = sv.SenseVoiceConfig(
    vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
)
TINY_DICT = dict(vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                 num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5)


def _make_artifact(folder):
    params = sv.init_params(TINY, jax.random.PRNGKey(0))
    meta = ModelMetadata(family="sensevoice", extra={"config": TINY_DICT})
    save_model(folder, params, meta)


def test_inspect_and_transcribe(tmp_path, capsys):
    _make_artifact(tmp_path / "m")
    assert main(["inspect", "--model-dir", str(tmp_path / "m")]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["family"] == "sensevoice"

    from asr_jax.runtime.examples import fixture_path

    wav = str(fixture_path("en/test_sample.wav"))
    assert main(["transcribe", "--model-dir", str(tmp_path / "m"), "--language", "en", wav]) == 0
    text = capsys.readouterr().out
    assert "RTF" in text


def test_quantize_roundtrip(tmp_path, capsys):
    _make_artifact(tmp_path / "m")
    assert main(["quantize", "--model-dir", str(tmp_path / "m"),
                 "--out", str(tmp_path / "q"), "--bits", "8", "--block", "32"]) == 0
    meta = json.loads((tmp_path / "q" / "metadata.json").read_text())
    assert meta["extra"]["quantization"]["bits"] == 8


def test_cli_build_firered(tmp_path):
    """`asr_jax build` end-to-end: synthetic FireRed checkpoint -> artifact
    -> transcribe-able session."""
    import torch

    from asr_jax.cli import main, _build_session
    from tests.test_firered import TINY, _firered_sd

    rng = np.random.default_rng(1)
    src = tmp_path / "ckpt"
    src.mkdir()
    torch.save({"args": {}, "model_state_dict": _firered_sd(TINY, rng)},
               src / "model.pth.tar")
    (src / "dict.txt").write_text("\n".join(f"t{i} {i}" for i in range(TINY.vocab_size)))
    out = tmp_path / "artifact"
    rc = main(["--platform", "cpu", "build", "--family", "firered",
               "--checkpoint", str(src), "--out", str(out)])
    assert rc == 0
    sess = _build_session(out)
    assert type(sess).__name__ == "FireRedSession"


def test_cli_parity_harness(tmp_path):
    """parity: transcribe fixtures, capture goldens, detect drift."""
    import json

    import torch

    from asr_jax.cli import main
    from tests.test_firered import TINY, _firered_sd

    rng = np.random.default_rng(2)
    src = tmp_path / "ckpt"
    src.mkdir()
    torch.save({"args": {}, "model_state_dict": _firered_sd(TINY, rng)},
               src / "model.pth.tar")
    (src / "dict.txt").write_text("\n".join(f"t{i} {i}" for i in range(TINY.vocab_size)))
    art = tmp_path / "artifact"
    assert main(["--platform", "cpu", "build", "--family", "firered",
                 "--checkpoint", str(src), "--out", str(art)]) == 0

    golden = tmp_path / "golden.json"
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--save-golden", str(golden)]) == 0
    wrapped = json.loads(golden.read_text())
    # Versioned schema (v2): fixtures nest under "fixtures" so future
    # fields never collide with fixture names.
    assert wrapped["golden_schema"] == 2
    data = wrapped["fixtures"]
    assert "zh-Shanghai.wav" in data
    # Stage probes captured alongside the transcripts (runtime/probe.py):
    # front-end, encoder and first-step logits snapshots.
    probe = data["zh-Shanghai.wav"]["probe"]
    assert set(probe) == {"frontend", "encoder", "logits"}
    assert probe["encoder"]["head"] and probe["logits"]["shape"]

    # Same run -> OK (v2 round trip); the same fixtures as a BARE dict
    # (the v1 pre-versioning format) must stay readable forever.
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--golden", str(golden)]) == 0
    v1 = tmp_path / "golden_v1.json"
    v1.write_text(json.dumps(data))
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--golden", str(v1)]) == 0
    data["zh-Shanghai.wav"]["token_ids"] = [1, 2, 3]
    data["zh-Shanghai.wav"]["text"] = "different"
    golden.write_text(json.dumps({"golden_schema": 2, "fixtures": data}))
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--golden", str(golden)]) == 1

    # Both flags on a not-yet-existing file: capture mode wins, --golden
    # is never read (the one-command "refresh goldens in place" shape).
    fresh = tmp_path / "fresh.json"
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--golden", str(fresh), "--save-golden", str(fresh)]) == 0
    assert "zh-Shanghai.wav" in json.loads(fresh.read_text())["fixtures"]


def test_cli_parity_probe_localizes_stage(tmp_path, capsys):
    """A drifting probe names the FIRST drifting stage (encoder here, not
    the downstream logits), localizing a future checkpoint mismatch to
    encoder vs decode; transcript-only goldens still compare clean."""
    import torch

    from asr_jax.cli import main
    from tests.test_firered import TINY, _firered_sd

    rng = np.random.default_rng(3)
    src = tmp_path / "ckpt"
    src.mkdir()
    torch.save({"args": {}, "model_state_dict": _firered_sd(TINY, rng)},
               src / "model.pth.tar")
    (src / "dict.txt").write_text("\n".join(f"t{i} {i}" for i in range(TINY.vocab_size)))
    art = tmp_path / "artifact"
    assert main(["--platform", "cpu", "build", "--family", "firered",
                 "--checkpoint", str(src), "--out", str(art)]) == 0

    golden = tmp_path / "golden.json"
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--save-golden", str(golden)]) == 0
    data = json.loads(golden.read_text())["fixtures"]
    name = next(iter(data))
    # Perturb the ENCODER snapshot; logits stay as captured -> the report
    # must blame the encoder stage (pipeline-ordered first drift).
    data[name]["probe"]["encoder"]["head"][0] += 1.0
    golden.write_text(json.dumps(data))
    capsys.readouterr()
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--golden", str(golden)]) == 1
    out = capsys.readouterr().out
    assert "first drift at stage 'encoder'" in out

    # Transcript-only golden (pre-probe format) still works.
    for v in data.values():
        v.pop("probe", None)
        v["token_ids"] = []  # fall back to text compare
    golden.write_text(json.dumps(data))
    assert main(["--platform", "cpu", "parity", "--model-dir", str(art),
                 "--golden", str(golden)]) == 0


def test_capture_probe_sensevoice_and_whisper():
    """capture_probe covers the CTC (sensevoice) and AED (whisper) session
    shapes; unsupported sessions return None (transcript-only goldens)."""
    from asr_jax.models import whisper as wh
    from asr_jax.runtime.probe import capture_probe, compare_probes
    from asr_jax.runtime.session import SenseVoiceSession
    from asr_jax.runtime.whisper_session import WhisperSession

    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(8000) * 2000).astype(np.float32)

    sv_params = sv.init_params(TINY, jax.random.PRNGKey(0))
    sv_sess = SenseVoiceSession(sv_params, TINY, window_seconds=0.5)
    p = capture_probe(sv_sess, audio)
    assert set(p) == {"frontend", "logits"}
    assert compare_probes(p, p) == []

    wcfg = wh.WhisperConfig(
        vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=4, n_mels=16, max_source_positions=40,
        max_target_positions=24, sot_id=1, eot_id=2, first_language_id=10,
        num_languages=4, no_speech_id=30,
    )
    w_sess = WhisperSession(wh.init_params(wcfg, jax.random.PRNGKey(1)), wcfg,
                            window_seconds=0.8)
    pw = capture_probe(w_sess, (rng.standard_normal(6400) * 0.05).astype(np.float32))
    assert set(pw) == {"frontend", "encoder", "logits"}
    assert compare_probes(pw, pw) == []
    # drift in the front-end is blamed on the front-end, not downstream
    bad = {**pw, "frontend": {**pw["frontend"],
                              "head": [v + 1 for v in pw["frontend"]["head"]]}}
    msgs = compare_probes(bad, pw)
    assert msgs and "stage 'frontend'" in msgs[0]

    assert capture_probe(object(), audio) is None


def test_serve_stream_rejects_non_streaming_family(tmp_path):
    """serve-stream on an offline artifact fails loudly naming the
    streaming families instead of crashing into the runner."""
    import dataclasses

    import pytest

    from asr_jax.cli import main
    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.artifact import save_model
    from asr_jax.runtime.metadata import ModelMetadata

    cfg = sv.SenseVoiceConfig(
        vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    folder = tmp_path / "art"
    folder.mkdir()
    save_model(folder, params, ModelMetadata(
        family="sensevoice", extra={"config": dataclasses.asdict(cfg)}))
    with pytest.raises(SystemExit, match="streaming families"):
        main(["serve-stream", "--model-dir", str(folder), "--streams", "2"])
