"""MP3 ingest via libmpg123.

The repository generates its audio fixtures from a seed and has no MP3
encoder, so these tests need a directory of MP3 recordings named by
``ASR_JAX_MP3_EXAMPLES`` (the reference's ``Test_Examples/`` layout) and
skip without one.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from asr_jax.runtime import mp3
from asr_jax.runtime import audio as audio_io

pytestmark = pytest.mark.skipif(not mp3.mpg123_available(), reason="libmpg123 unavailable")


@pytest.fixture
def mp3_dir():
    root = os.environ.get("ASR_JAX_MP3_EXAMPLES")
    if not root:
        pytest.skip("no MP3 fixture: none can be generated in-repo (no encoder); "
                    "set ASR_JAX_MP3_EXAMPLES to a Test_Examples directory")
    return Path(root)


def test_decode_fixture_mp3(mp3_dir):
    samples, rate = mp3.read_mp3(mp3_dir / "ja" / "ja.mp3")
    assert rate in (16000, 22050, 24000, 32000, 44100, 48000)
    assert samples.ndim == 2 and samples.shape[1] > rate  # > 1 second
    assert np.abs(samples).max() > 100  # int16 numeric range, non-silent


def test_load_audio_mp3_end_to_end(mp3_dir):
    out = audio_io.load_audio(mp3_dir / "ko" / "ko.mp3", 16000)
    assert out.ndim == 1 and out.dtype == np.float32
    assert len(out) > 16000
