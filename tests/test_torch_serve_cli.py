"""The serving daemon, cli/serve.py, in-process on the CPU.

configs/tiny.yaml with random weights and --device cpu on an ephemeral
loopback port, once per scheduler (the continuous one after warm_serving,
which must leave no speaker behind): /healthz, /register_speaker with a
base64 WAV, three concurrent /synthesize requests each answered with a
24 kHz mono 16-bit WAV, and 400 for bad payloads, 500 for an unknown
speaker.
"""
import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from minimax_speech_torch.cli import serve
from tests.conftest import synthetic_audio
from tests import torch_cpu

torch_cpu.share_cores()


def _wav_b64(audio: np.ndarray, sr: int) -> str:
    return base64.b64encode(serve.wav_bytes(audio, sr)).decode()


def _post(url: str, payload) -> tuple[int, bytes]:
    data = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("scheduler", ["window", "continuous"])
def test_serve_answers_over_http(scheduler):
    argv = ["--random_init", "--config", "configs/tiny.yaml", "--device",
            "cpu", "--port", "0", "--scheduler", scheduler, "--slots", "2",
            "--max_batch", "2", "--override", "model.max_speech_tokens=12"]
    httpd, server, _ = serve.build_server(serve.parse_args(
        argv + ([] if scheduler == "continuous" else ["--no_warm"])))
    assert server.tts.list_available_spks() == []  # warm-up cleaned up
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200 and r.read() == b"ok"
        rng = np.random.default_rng(0)
        # a 24 kHz stereo prompt: the server mixes it down and resamples
        prompt = np.stack([synthetic_audio(rng, 0.5, 24000)] * 2, axis=1)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(24000)
            w.writeframes((prompt * 32767).astype(np.int16).tobytes())
        code, _ = _post(base + "/register_speaker",
                        {"id": "spk", "prompt_text": "hello",
                         "wav_b64": base64.b64encode(buf.getvalue())
                         .decode()})
        assert code == 200
        assert server.tts.list_available_spks() == ["spk"]

        texts = ["one two three.", "a much longer sentence here.", "hi."]
        with ThreadPoolExecutor(3) as pool:
            answers = list(pool.map(lambda t: _post(
                base + "/synthesize", {"text": t, "speaker": "spk"}), texts))
        for code, body in answers:
            assert code == 200
            with wave.open(io.BytesIO(body)) as w:
                assert (w.getframerate(), w.getnchannels(),
                        w.getsampwidth()) == (24000, 1, 2)
                n = w.getnframes()
            assert n > 0 and n % 960 == 0

        assert _post(base + "/synthesize", b"{not json")[0] == 400
        assert _post(base + "/register_speaker", {"id": "x"})[0] == 400
        assert _post(base + "/register_speaker",
                     {"id": "x", "wav_b64": "***"})[0] == 400
        assert _post(base + "/register_speaker",
                     {"id": "x", "wav_b64": base64.b64encode(b"RIFFjunk")
                      .decode()})[0] == 400
        assert _post(base + "/synthesize",
                     {"text": "hi.", "speaker": "nobody"})[0] == 500
        assert _post(base + "/nowhere", {})[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(30)
    assert not thread.is_alive()


def test_wav_round_trip_resamples_to_16k():
    audio = synthetic_audio(np.random.default_rng(1), 0.25, 24000)
    back = serve.decode_wav_b64(_wav_b64(audio, 24000))
    assert back.dtype == np.float32 and len(back) == 4000
    same = serve.decode_wav_b64(_wav_b64(audio[:4000], 16000))
    np.testing.assert_allclose(same, audio[:4000], atol=2 / 32768)
