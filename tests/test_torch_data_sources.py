"""The port's speech data sources against the JAX package's, on the CPU:
mp3 decode (data/mp3.py and the pipeline's opener), the native C++
loader (data/native_loader.py, built under build/native/), the parquet
opener and every cli/data_tools.py subcommand. These are host code with
exact arithmetic on both sides, so outputs are compared for equality.
"""
import struct

import numpy as np
import pytest

from minimax_speech_torch.cli import data_tools as t_tools
from minimax_speech_torch.data import mp3 as t_mp3
from minimax_speech_torch.data import native_loader as t_nl
from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_tpu.cli import data_tools as j_tools
from minimax_speech_tpu.data import mp3 as j_mp3
from minimax_speech_tpu.data import native_loader as j_nl
from minimax_speech_tpu.data import pipeline as j_dp
from tests.conftest import synthetic_audio
from tests.test_mp3 import write_mp3
from tests import torch_cpu

torch_cpu.share_cores()


def _needs_mpg123():
    if not j_mp3.mpg123_available():
        pytest.skip("libmpg123 not on this system")


@pytest.mark.parametrize("tone,gain", [(False, 190), (True, 190),
                                       (True, 198)])
def test_mp3_decode_matches_jax(tmp_path, tone, gain):
    """Layer III frames of tests/test_mp3.py's writer: samples and rate
    identical to JAX's decode_mp3, directly and through _load_audio."""
    _needs_mpg123()
    p = str(write_mp3(tmp_path / "a.mp3", n_frames=12, tone=tone,
                      global_gain=gain))
    ours, sr = t_mp3.decode_mp3(p)
    ref, sr_ref = j_mp3.decode_mp3(p)
    assert sr == sr_ref == 44100 and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    via, sr_via = t_dp._load_audio(p)
    assert sr_via == sr
    np.testing.assert_array_equal(via, ref)
    if tone:
        assert np.abs(ours).max() > 1e-3


def test_mp3_sniffing_and_errors_match_jax(tmp_path, rng):
    """Content wins over the extension (a RIFF named .mp3 is a wav), an
    ID3 tag before RIFF is not mp3; a file with no frames raises IOError
    on both sides and the opener skips it."""
    from tests.test_cli import write_wav

    wav = tmp_path / "fake.mp3"
    write_wav(wav, synthetic_audio(rng, 0.2, 16000), 16000)
    tagged = tmp_path / "tagged.mp3"
    tagged.write_bytes(b"ID3\x04\x00\x00\x00\x00\x00\x04" + bytes(4)
                       + wav.read_bytes())
    empty = tmp_path / "empty.mp3"
    empty.write_bytes(b"ID3\x04" + bytes(32))
    for p in (wav, tagged, empty):
        assert t_mp3.looks_like_mp3(str(p)) == j_mp3.looks_like_mp3(str(p))
    assert not t_mp3.looks_like_mp3(str(wav))
    a, sr = t_dp._load_audio(str(wav))
    b, _ = j_dp._load_audio(str(wav))
    np.testing.assert_array_equal(a, b)
    _needs_mpg123()
    for decode in (t_mp3.decode_mp3, j_mp3.decode_mp3):
        with pytest.raises(IOError):
            decode(str(empty))
    assert list(t_dp.individual_file_opener([{"src": str(empty)}])) == []


def _riff(path, x, sr, fmt: str):
    """x: (n, channels) float in [-1, 1) written as PCM 16/24/32-bit or
    IEEE float32."""
    nch = x.shape[1]
    if fmt == "float":
        tag, bits, data = 3, 32, x.astype("<f4").tobytes()
    else:
        bits = int(fmt[3:])
        q = np.clip(np.round(x * 2 ** (bits - 1)), -2 ** (bits - 1),
                    2 ** (bits - 1) - 1).astype("<i4")
        tag = 1
        data = (q.astype("<i2").tobytes() if bits == 16 else q.tobytes()
                if bits == 32 else b"".join(
                    int(v).to_bytes(3, "little", signed=True)
                    for v in q.ravel()))
    block = nch * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", tag, nch, sr, sr * block, block, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk + b"data"
            + struct.pack("<I", len(data)) + data)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return str(path)


@pytest.fixture(scope="module")
def native_built():
    if not (t_nl.native_available() and j_nl.native_available()):
        pytest.skip("g++ or the Python headers are not on this system")
    return True


@pytest.mark.parametrize("target_sr", [0, 24000])
@pytest.mark.parametrize("fmt,nch", [("pcm16", 1), ("pcm24", 1),
                                     ("pcm32", 1), ("float", 1),
                                     ("pcm16", 2)])
def test_batch_load_matches_jax(native_built, tmp_path, rng, fmt, nch,
                                target_sr):
    """batch_load of 3 wavs at 16 kHz in 2 threads, as read or resampled
    to 24 kHz: every sample and rate identical to JAX's; the port's
    library lies under build/native/, not beside the source."""
    paths = [_riff(tmp_path / f"{i}.wav", rng.uniform(
        -0.9, 0.9, (1600 + 311 * i, nch)), 16000, fmt) for i in range(3)]
    ours = t_nl.batch_load(paths, target_sr, num_threads=2)
    ref = j_nl.batch_load(paths, target_sr, num_threads=2)
    for (a, sr_a), (b, sr_b) in zip(ours, ref):
        assert sr_a == sr_b == (target_sr or 16000)
        np.testing.assert_array_equal(a, b)
    lib = t_nl.library_path()
    assert lib.exists() and lib.parent == t_nl.ROOT / "build" / "native"


def test_batch_load_fallback_matches_jax(tmp_path, rng, monkeypatch):
    """Without the extension both sides decode with their Python loader
    (16-bit wav and mp3) and resample alike; errors raise IOError."""
    monkeypatch.setattr(t_nl, "_native", lambda: None)
    monkeypatch.setattr(j_nl, "_load_native", lambda: None)
    paths = [_riff(tmp_path / f"{i}.wav", rng.uniform(-0.9, 0.9, (
        1000 + 97 * i, 1)), 16000, "pcm16") for i in range(2)]
    for target_sr in (0, 22050):
        for (a, sr_a), (b, sr_b) in zip(t_nl.batch_load(paths, target_sr),
                                        j_nl.batch_load(paths, target_sr)):
            assert sr_a == sr_b
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IOError):
        t_nl.batch_load([str(tmp_path / "missing.wav")])


def test_native_file_opener_matches_jax(native_built, tmp_path, rng):
    """native_file_opener in groups of 2 over a corpus with one missing
    file: the group that holds it is skipped on both sides, the rest
    carry identical audio, tokens, latents and rejects."""
    from tests.test_torch_train_cli import dpo_corpus

    lst = dpo_corpus(tmp_path, rng, n=5)
    items = [{"src": w} for w in lst.read_text().splitlines()]
    items.insert(3, {"src": str(tmp_path / "missing.wav")})
    ours = list(t_nl.native_file_opener([dict(i) for i in items], 2, 2))
    ref = list(j_nl.native_file_opener([dict(i) for i in items],
                                       prefetch=2, num_threads=2))
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert o.keys() == r.keys()
        for k in r:
            if isinstance(r[k], np.ndarray):
                np.testing.assert_array_equal(o[k], r[k], err_msg=k)
            else:
                assert o[k] == r[k], k


def _tools_corpus(tmp_path, rng):
    """3 complete utterances, one without sidecars, one with out-of-range
    tokens (validate flags it), a .normalized.txt transcript."""
    from tests.test_data_tools import make_corpus
    from tests.test_cli import write_wav

    make_corpus(tmp_path, rng, 3)
    write_wav(tmp_path / "orphan.wav", synthetic_audio(rng, 0.2, 24000),
              24000)
    write_wav(tmp_path / "spk9_x.wav", synthetic_audio(rng, 0.3, 24000),
              24000)
    (tmp_path / "spk9_x.normalized.txt").write_text("normalized text")
    np.save(tmp_path / "u1_fsq.npy", np.array([1, 2, 7000]))


@pytest.mark.parametrize("cmd", ["create_list", "create_list_all", "validate",
                                 "index", "make_parquet", "manifest"])
def test_data_tools_match_jax(tmp_path, rng, capsys, cmd):
    """Each subcommand on both sides over one corpus: return codes,
    printed lines and written files identical (parquet shards compared
    by their rows, the shard list up to its directory)."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    _tools_corpus(corpus, rng)
    lst = corpus.parent / "all.txt"
    j_tools.main(["create_list", "--dir", str(corpus), "--out", str(lst),
                  "--all"])
    capsys.readouterr()
    out = {}
    for name, tools in (("jax", j_tools), ("port", t_tools)):
        d = tmp_path / name
        argv = {"create_list": ["--dir", str(corpus), "--out", str(d)],
                "create_list_all": ["--dir", str(corpus), "--out", str(d),
                                    "--all"],
                "validate": ["--list", str(lst)],
                "index": ["--dir", str(corpus), "--out", str(d)],
                "make_parquet": ["--list", str(lst), "--out_dir", str(d),
                                 "--per_shard", "2"],
                "manifest": ["--dir", str(corpus), "--out_dir", str(d)]}[cmd]
        rc = tools.main([cmd.replace("_all", ""), *argv])
        printed = capsys.readouterr()
        files = {}
        for f in sorted([d] if d.is_file() else d.rglob("*")):
            rel = str(f.relative_to(d))
            if f.suffix == ".parquet":
                import pyarrow.parquet as pq
                files[rel] = pq.read_table(f).to_pylist()
            else:
                files[rel] = f.read_text().replace(str(d), "<out>")
        out[name] = (rc, printed.out.replace(str(d), "<out>"),
                     printed.err, files)
    assert out["port"] == out["jax"]
    rc, printed, _, files = out["port"]
    assert files or printed
    if cmd == "validate":
        assert rc == 1 and "invalid fsq tokens" in printed


def test_parquet_opener_matches_jax(tmp_path, rng):
    """make_parquet shards of a corpus through both openers, and a shard
    that does not load (skipped and logged): every row's fields equal."""
    from tests.test_data_tools import make_corpus

    make_corpus(tmp_path, rng, 3)
    lst = tmp_path / "l.txt"
    t_tools.main(["create_list", "--dir", str(tmp_path), "--out", str(lst)])
    t_tools.main(["make_parquet", "--list", str(lst), "--out_dir",
                  str(tmp_path / "shards"), "--per_shard", "2"])
    bad = tmp_path / "shards" / "bad.parquet"
    bad.write_bytes(b"not parquet")
    srcs = [{"src": p, "split": "train"} for p in (tmp_path / "shards" /
            "data.list").read_text().split()] + [{"src": str(bad)}]
    ours = list(t_dp.parquet_opener([dict(s) for s in srcs]))
    ref = list(j_dp.parquet_opener([dict(s) for s in srcs]))
    assert len(ours) == len(ref) == 3
    for o, r in zip(ours, ref):
        assert o.keys() == r.keys() >= {"audio", "sample_rate", "text",
                                        "speech_token", "utt", "split"}
        assert o["sample_rate"] == 24000 and len(o["audio"]) > 0
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert o[k].dtype == r[k].dtype
                np.testing.assert_array_equal(o[k], r[k], err_msg=k)
            else:
                assert o[k] == r[k], k


@pytest.mark.parametrize("require_latent", [True, False])
def test_opener_skips_truncated_wav_as_jax(tmp_path, rng, capsys,
                                           require_latent):
    """A 16-bit wav cut one byte short (numpy refuses its odd-length data
    with ValueError) among good ones, and a wav with .txt and _fsq but no
    latent: on both sides the opener skips and logs the truncated one
    and raises nothing; with require_latent=False the latent-less wav
    carries its whole tokens, with True it is skipped. Items identical."""
    from tests.test_train_cli import make_corpus
    from tests.test_cli import write_wav

    lst = make_corpus(tmp_path, rng, n=3)
    bad = tmp_path / "cut.wav"
    write_wav(bad, synthetic_audio(rng, 0.3, 24000), 24000)
    bad.write_bytes(bad.read_bytes()[:-1])
    write_wav(tmp_path / "nolat.wav", synthetic_audio(rng, 0.5, 24000),
              24000)
    (tmp_path / "nolat.txt").write_text("no latent")
    np.save(tmp_path / "nolat_fsq.npy", rng.integers(0, 6561, 13))
    items = [{"src": w} for w in lst.read_text().splitlines()]
    items[1:1] = [{"src": str(bad)}, {"src": str(tmp_path / "nolat.wav")}]
    ours = list(t_dp.individual_file_opener([dict(i) for i in items],
                                            require_latent=require_latent))
    ref = list(j_dp.individual_file_opener([dict(i) for i in items],
                                           require_latent=require_latent))
    assert "opener skip" in capsys.readouterr().out
    assert len(ours) == len(ref) == (4 if not require_latent else 3)
    assert str(bad) not in [o["src"] for o in ours]
    for o, r in zip(ours, ref):
        assert o.keys() == r.keys()
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert o[k].dtype == r[k].dtype, k
                np.testing.assert_array_equal(o[k], r[k], err_msg=k)
            else:
                assert o[k] == r[k], k
    if not require_latent:
        nolat = [o for o in ours if o["src"].endswith("nolat.wav")][0]
        assert len(nolat["speech_token"]) == 13
        assert "speech_latent" not in nolat
