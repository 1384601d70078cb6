"""The port's host tools against the JAX package's, on the CPU: the model
registry, the hub card and upload, the listening-test server, the two
downloaders (with --convert), the small functions the twin modules
lacked (FSQ digits, the pad mask, mpg123_available, the profiler region,
two schedules), and the file lists of the two packages.

Every comparison runs the same inputs through both packages: manifests,
CSVs, wavs and transcripts byte for byte, converted .npz files array for
array. The network never takes part: a file:// mirror stands in for the
hub, in-memory samples for the streaming dataset, and a stub module for
huggingface_hub.
"""
import csv
import hashlib
import json
import re
import shutil
import sys
import threading
import types
import urllib.error
import urllib.parse
import urllib.request
import wave
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from minimax_speech_torch import config as t_config
from minimax_speech_torch.cli import download_dataset as t_dd
from minimax_speech_torch.cli import download_pretrained as t_dp
from minimax_speech_torch.cli import hub_tools as t_hub
from minimax_speech_torch.data import mp3 as t_mp3
from minimax_speech_torch.data.native_loader import native_available
from minimax_speech_torch.ops import fsq as t_fsq
from minimax_speech_torch.ops import masks as t_masks
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.utils import logging as t_logging
from minimax_speech_torch.utils import preference as t_pref
from minimax_speech_torch.utils import registry as t_reg
from minimax_speech_tpu.cli import download_dataset as j_dd
from minimax_speech_tpu.cli import download_pretrained as j_dp
from minimax_speech_tpu.cli import hub_tools as j_hub
from minimax_speech_tpu.data import mp3 as j_mp3
from minimax_speech_tpu.ops import fsq as j_fsq
from minimax_speech_tpu.ops import masks as j_masks
from minimax_speech_tpu.train import schedule as j_sched
from minimax_speech_tpu.utils import params_io as j_io
from minimax_speech_tpu.utils import preference as j_pref
from minimax_speech_tpu.utils import registry as j_reg
from tests.test_convert import arr, speaker_sd
from tests.test_torch_convert import qwen_sd, s3_sd
from tests import torch_cpu

torch_cpu.share_cores()

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": j_reg, "torch": t_reg}


# -- registry -----------------------------------------------------------------

def model_dir(root: Path, seed: int = 0) -> Path:
    """A model directory of seeded arrays, written once: llm.npz, flow.npz,
    a config.json, a .tiktoken asset and a file no pattern matches."""
    rng = np.random.default_rng(seed)
    d = root / "m"
    d.mkdir(parents=True)
    for kind in ("llm", "flow"):
        j_io.save_params(str(d / f"{kind}.npz"), {"params": {
            "w": rng.standard_normal((3, 4)).astype(np.float32),
            "sub": {"b": rng.standard_normal(5).astype(np.float32)}}})
    (d / "config.json").write_text('{"a": 1}')
    (d / "vocab.tiktoken").write_bytes(rng.bytes(64))
    (d / "notes.txt").write_text("not hashed")
    return d


def test_manifests_byte_equal_and_cross_verify(tmp_path):
    d = model_dir(tmp_path)
    j_man = j_reg.write_manifest(d)
    j_bytes = (d / "manifest.json").read_bytes()
    t_man = t_reg.write_manifest(d)
    assert (d / "manifest.json").read_bytes() == j_bytes
    assert t_man == j_man and set(t_man["files"]) == {
        "llm.npz", "flow.npz", "config.json", "vocab.tiktoken"}
    # each package verifies the other's manifest (the port's is on disk)
    assert j_reg.verify_model_dir(d) == [] == t_reg.verify_model_dir(d)
    j_reg.write_manifest(d)
    assert t_reg.verify_model_dir(d) == []
    # one flipped byte: the same problem in both
    raw = bytearray((d / "flow.npz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (d / "flow.npz").write_bytes(bytes(raw))
    assert j_reg.verify_model_dir(d) == t_reg.verify_model_dir(d) == [
        "sha256 mismatch: flow.npz"]
    (d / "flow.npz").unlink()
    assert j_reg.verify_model_dir(d) == t_reg.verify_model_dir(d) == [
        "missing file flow.npz"]
    (d / "manifest.json").unlink()
    assert t_reg.verify_model_dir(d) == ["missing manifest.json"]


def test_load_model_gives_jax_arrays(tmp_path):
    d = model_dir(tmp_path)
    t_reg.write_manifest(d)
    for kind in ("llm", "flow"):
        ours, theirs = t_reg.load_model(str(d), kind), \
            j_reg.load_model(str(d), kind)
        assert ours.keys() == theirs.keys() == {"params"}
        np.testing.assert_array_equal(ours["params"]["w"],
                                      theirs["params"]["w"])
        np.testing.assert_array_equal(ours["params"]["sub"]["b"],
                                      theirs["params"]["sub"]["b"])


def test_register_load_and_available(tmp_path):
    """tests/test_registry.py's case on the port: a persisted registry,
    and a corrupted model refused."""
    d = model_dir(tmp_path)
    t_reg.write_manifest(d)
    reg_file = tmp_path / "registry.json"
    t_reg.register("tiny-tts", d, persist_to=str(reg_file))
    assert "tiny-tts" in t_reg.available_models()
    tree = t_reg.load_model("tiny-tts", kind="llm")
    assert tree["params"]["w"].shape == (3, 4)
    t_reg._MODELS.clear()
    t_reg.load_registry(str(reg_file))
    assert t_reg.resolve("tiny-tts") == d
    (d / "llm.npz").write_bytes(b"xx")
    with pytest.raises(ValueError, match="verification"):
        t_reg.load_model("tiny-tts", kind="llm")
    t_reg._MODELS.clear()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_fetcher_and_refetch(pkg, tmp_path):
    """tests/test_registry.py's fetcher cases, the same in both packages:
    a missing dir is fetched, a corrupted one re-fetched once, a failing
    fetcher leaves no dir behind, and a missing manifest alone is never
    re-fetched over the user's files."""
    reg = PACKAGES[pkg]
    d = tmp_path / "rf"
    calls = []

    def fetcher(name, dd):
        calls.append(name)
        j_io.save_params(str(dd / "llm.npz"),
                         {"params": {"w": np.ones((2,), np.float32)}})
        reg.write_manifest(dd)

    tree = reg.load_model(str(d), kind="llm", fetcher=fetcher)
    assert calls == [str(d)] and "w" in tree["params"]
    (d / "llm.npz").write_bytes(b"junk")
    tree = reg.load_model(str(d), kind="llm", fetcher=fetcher)
    assert len(calls) == 2 and "w" in tree["params"]
    assert [p.name for p in tmp_path.iterdir()] == ["rf"]  # swapped in

    def bad_fetcher(name, dd):
        (dd / "half.npz").write_bytes(b"partial")
        raise OSError("network down")

    d2 = tmp_path / "boom"
    with pytest.raises(OSError):
        reg.load_model(str(d2), kind="llm", fetcher=bad_fetcher)
    assert not d2.exists()
    (d / "manifest.json").unlink()
    with pytest.raises(ValueError, match="missing manifest"):
        reg.load_model(str(d), kind="llm", fetcher=bad_fetcher)
    assert (d / "llm.npz").exists()


def test_downloaded_manifest_verifies_nothing(tmp_path):
    """A fault of the reference that the port keeps: download_pretrained
    writes {name: {"sha256", "bytes"}}, verify_model_dir reads only
    manifest["files"], so a downloaded directory verifies in both
    packages even with a corrupted file."""
    src = _mirror(tmp_path)
    out = tmp_path / "model"
    t_dp.main(["--model_dir", str(out), "--base_url", src.as_uri(),
               "--files", "llm.pt", "cosyvoice2.yaml"])
    manifest = json.loads((out / "manifest.json").read_text())
    assert "files" not in manifest and set(manifest) == {"llm.pt",
                                                         "cosyvoice2.yaml"}
    (out / "llm.pt").write_bytes(b"corrupted")
    assert t_reg.verify_model_dir(out) == [] == j_reg.verify_model_dir(out)


# -- hub card and upload ------------------------------------------------------

def _sections(card: str) -> tuple:
    files = card.split("## Files")[1].split("## Usage")[0].strip()
    metrics = card.split("## Metrics")[1].strip() if "## Metrics" in card \
        else ""
    return files, metrics


@pytest.mark.parametrize("with_metrics", [False, True])
def test_card_lists_what_jax_lists(with_metrics, tmp_path):
    d = model_dir(tmp_path)
    if with_metrics:
        (d / "metrics.json").write_text(json.dumps({"wer": 0.031,
                                                    "sim": 0.71}))
    ours, theirs = t_hub.make_card(d), j_hub.make_card(d)
    assert _sections(ours) == _sections(theirs)
    assert ("## Metrics" in ours) == with_metrics
    assert not re.search(r"\b(tpu|jax)\b", ours, re.IGNORECASE)
    assert "library_name: minimax_speech_torch" in ours
    assert "from minimax_speech_torch.infer.api import TTS" in ours
    for tag in ("pytorch", "cuda", "h100"):
        assert tag in ours.split("---")[1]


def _stub_hub(calls):
    hub = types.ModuleType("huggingface_hub")

    class HfApi:
        def create_repo(self, repo, **kw):
            calls.append(("create_repo", repo, kw))

        def upload_folder(self, **kw):
            calls.append(("upload_folder", kw))

    hub.HfApi = HfApi
    return hub


def test_upload_makes_jax_calls(tmp_path, monkeypatch, capsys):
    d = model_dir(tmp_path)
    got = {}
    for name, main in (("jax", j_hub.main), ("torch", t_hub.main)):
        calls = []
        monkeypatch.setitem(sys.modules, "huggingface_hub", _stub_hub(calls))
        main(["upload", "--model_dir", str(d), "--repo", "user/tts",
              "--private"])
        got[name] = calls
    assert got["torch"] == got["jax"] == [
        ("create_repo", "user/tts", {"private": True, "exist_ok": True}),
        ("upload_folder", {"folder_path": str(d), "repo_id": "user/tts"})]
    assert (d / "README.md").read_text() == t_hub.make_card(d)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(SystemExit, match="huggingface_hub"):
        t_hub.main(["upload", "--model_dir", str(d), "--repo", "user/tts"])
    t_hub.main(["card", "--model_dir", str(d)])
    assert "wrote" in capsys.readouterr().out


# -- the listening-test server ------------------------------------------------

def _corpus(root: Path, conditions=("ref", "a", "b"), n=5) -> Path:
    for c in conditions:
        d = root / c
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            with wave.open(str(d / f"s{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(8000)
                w.writeframes(np.full(80, i, np.int16).tobytes())
    return root


@pytest.mark.parametrize("seed", [0, 7, None])
def test_samples_order_and_filter_as_jax(seed, tmp_path):
    root = _corpus(tmp_path / "c")
    save = tmp_path / "r.csv"
    j_pref.save_result({"user": "u1", "sample": "s3.wav", "a": 1}, str(save))
    j_pref.save_result({"user": "u2", "sample": "s1.wav", "a": 2}, str(save))
    ours, theirs = t_pref.Samples(str(root), seed=seed), \
        j_pref.Samples(str(root), seed=seed)
    if seed is not None:
        assert ours.names == theirs.names
    assert ours.conditions() == theirs.conditions() == ["a", "b", "ref"]
    assert ours.samples == theirs.samples
    for s in (ours, theirs):
        s.names = sorted(s.names) if seed is None else s.names
        s.filter_completed("u1", str(save))
    assert ours.names == theirs.names and "s3.wav" not in ours.names
    o = t_pref.Samples(str(root), seed=3, n_samples=2)
    t = j_pref.Samples(str(root), seed=3, n_samples=2)
    o.filter_completed("u2", str(save))
    t.filter_completed("u2", str(save))
    assert o.names == t.names and len(o) == 2
    assert o.get_next_sample("ref", ["a", "b"], seed=5) == \
        t.get_next_sample("ref", ["a", "b"], seed=5)
    assert o.order == t.order and o.progress() == t.progress()


SCORES = {"a": "77", "b": "33"}


def _rate_all(app_cls, root: Path, save: Path, mode: str) -> list:
    """Rate every page of a server on port 0 as one user: each condition
    by its name (the page's blind order decides only which field carries
    it), until the server says no more samples. Returns the samples
    rated, in order."""
    app = app_cls(str(root), str(save), mode=mode, reference="ref", seed=11)
    srv = app.make_server(port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_port}"
    rated = []
    try:
        page = urllib.request.urlopen(base + "/?user=tester",
                                      timeout=10).read().decode()
        while "No more samples" not in page:
            sample = page.split('name="sample" value="')[1].split('"')[0]
            order = json.loads(page.split('name="order" value="')[1]
                               .split('"')[0].replace("&quot;", '"'))
            form = {"user": "tester", "sample": sample,
                    "order": json.dumps(order)}
            if mode == "mushra":
                form.update({f"score_{i}": SCORES[c]
                             for i, c in enumerate(order) if c in SCORES})
            else:
                form["pick"] = str(order.index("a"))
            rated.append(sample)
            # the 303 is followed to the next page
            page = urllib.request.urlopen(
                base + "/rate", data=urllib.parse.urlencode(form).encode(),
                timeout=10).read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                base + "/audio?f=" + urllib.parse.quote(str(save)),
                timeout=10)
        assert e.value.code == 403
    finally:
        srv.shutdown()
        srv.server_close()
    return rated


@pytest.mark.parametrize("mode", ["mushra", "abx"])
def test_server_writes_jax_csv(mode, tmp_path):
    root = _corpus(tmp_path / "c")
    out = {}
    for name, cls in (("jax", j_pref.PreferenceApp),
                      ("torch", t_pref.PreferenceApp)):
        save = tmp_path / f"{name}.csv"
        out[name] = (_rate_all(cls, root, save, mode), save.read_bytes())
    assert out["torch"] == out["jax"]
    rated, raw = out["torch"]
    assert len(rated) == 5
    rows = list(csv.DictReader(raw.decode().splitlines()))
    assert [r["sample"] for r in rows] == rated
    if mode == "mushra":
        assert all((r["a"], r["b"]) == ("77", "33") for r in rows)
    else:
        assert all(r["preference"] == "a" for r in rows)


def test_server_audio_and_refusals(tmp_path):
    root = _corpus(tmp_path / "c", n=1)
    app = t_pref.PreferenceApp(str(root), str(tmp_path / "r.csv"))
    srv = app.make_server(port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_port}"
    try:
        f = root / "a" / "s0.wav"
        got = urllib.request.urlopen(
            base + "/audio?f=" + urllib.parse.quote(str(f)),
            timeout=10).read()
        assert got == f.read_bytes()
        for bad in ("/etc/passwd", str(root / "a" / ".." / "a" / "s0.wav")):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(
                    base + "/audio?f=" + urllib.parse.quote(bad), timeout=10)
            assert e.value.code == 403
    finally:
        srv.shutdown()
        srv.server_close()


# -- download_pretrained ------------------------------------------------------

def _mirror(tmp_path: Path) -> Path:
    src = tmp_path / "mirror"
    src.mkdir()
    (src / "llm.pt").write_bytes(b"fake-llm-bytes" * 100)
    (src / "cosyvoice2.yaml").write_text("model: {}\n")
    return src


def test_download_pretrained_as_jax(tmp_path):
    """tests/test_downloaders.py's fetch, manifest and skip on the port,
    and the same manifest bytes as the JAX CLI's."""
    src = _mirror(tmp_path)
    runs = {}
    for name, main in (("jax", j_dp.main), ("torch", t_dp.main)):
        out = tmp_path / name
        args = ["--model_dir", str(out), "--base_url", src.as_uri(),
                "--files", "llm.pt", "cosyvoice2.yaml"]
        main(args)
        runs[name] = (out, args)
    out, args = runs["torch"]
    assert (out / "manifest.json").read_bytes() == \
        (runs["jax"][0] / "manifest.json").read_bytes()
    manifest = json.loads((out / "manifest.json").read_text())
    for name in ("llm.pt", "cosyvoice2.yaml"):
        body = (src / name).read_bytes()
        assert (out / name).read_bytes() == body
        assert manifest[name] == {"sha256": hashlib.sha256(body).hexdigest(),
                                  "bytes": len(body)}
    for f in src.iterdir():  # present: no fetch (the mirror is gone)
        f.unlink()
    t_dp.main(args)
    with pytest.raises(urllib.error.URLError):
        t_dp.main(args + ["--no-skip_existing"])


def test_download_pretrained_resume(tmp_path):
    """A stale .part restarts from scratch where the server ignores Range
    (file:// always does): no stale prefix survives."""
    src = _mirror(tmp_path)
    out = tmp_path / "model"
    out.mkdir()
    (out / "llm.pt.part").write_bytes(b"fake-llm")
    digest = t_dp.fetch((src / "llm.pt").as_uri(), out / "llm.pt",
                        progress=False)
    got = (out / "llm.pt").read_bytes()
    assert got == b"fake-llm-bytes" * 100
    assert digest == hashlib.sha256(got).hexdigest()
    assert not (out / "llm.pt.part").exists()


def llm_state(c) -> dict:
    """A random upstream llm.pt state dict for the port's LMConfig `c`
    (tests/test_torch_convert.py's llm layout, at c's geometry)."""
    v, d = c.speech_token_size + 3, c.llm_input_size
    sd = {"llm_embedding.weight": arr(2, d),
          "speech_embedding.weight": arr(v, d),
          "llm_decoder.weight": arr(v, c.llm_output_size),
          "llm_decoder.bias": arr(v),
          "spk_embed_affine_layer.weight": arr(d, c.spk_embed_dim),
          "spk_embed_affine_layer.bias": arr(d)}
    s = c.speaker
    sd |= speaker_sd("speaker_encoder.", s.mel_dim, s.model_dim,
                     s.output_dim, s.num_blocks)
    sd |= qwen_sd(c.qwen, "llm.model.model.")
    return {"module." + k: a for k, a in sd.items()}


def test_convert_gives_jax_npz(tmp_path):
    """--convert at configs/tiny.yaml geometry: torch.save'd llm, flow
    and hift state dicts and .onnx files for the S3 tokenizer and CAM++,
    converted by both packages' convert_checkpoints (then main --convert
    on the port): the same keys and arrays in every .npz, and the
    manifest's hashes of the port's files."""
    config = str(REPO / "configs" / "tiny.yaml")
    cfg = t_config.load_tts_config(config)
    src = tmp_path / "src"
    src.mkdir()
    for name, sd in (("llm.pt", llm_state(cfg.lm)),
                     ("flow.pt", chip_smoke.upstream_flow_state(cfg.flow, 0)),
                     ("hift.pt", chip_smoke.upstream_hift_state(cfg.hift, 0))):
        torch.save({k: torch.as_tensor(a) for k, a in sd.items()}, src / name)
    chip_smoke.write_onnx(src / "speech_tokenizer_v2.onnx", s3_sd(cfg.s3))
    chip_smoke.write_onnx(src / "campplus.onnx", chip_smoke.campplus_state())
    dirs = {k: tmp_path / k for k in ("jax", "torch")}
    for d in dirs.values():
        shutil.copytree(src, d)
    made = j_dp.convert_checkpoints(dirs["jax"], config)
    assert t_dp.convert_checkpoints(dirs["torch"], config) == made == [
        "llm.npz", "flow.npz", "hift.npz", "s3.npz", "campplus.npz"]
    for dst in made:
        ours, theirs = np.load(dirs["torch"] / dst), np.load(dirs["jax"] / dst)
        assert sorted(ours.files) == sorted(theirs.files), dst
        for k in theirs.files:
            assert ours[k].dtype == theirs[k].dtype, (dst, k)
            np.testing.assert_array_equal(ours[k], theirs[k],
                                          err_msg=f"{dst} {k}")
    (dirs["torch"] / "manifest.json").write_text("{}")
    t_dp.main(["--model_dir", str(dirs["torch"]), "--files", "--convert",
               "--config", config])
    manifest = json.loads((dirs["torch"] / "manifest.json").read_text())
    assert set(manifest) == set(made)
    for dst in made:
        body = (dirs["torch"] / dst).read_bytes()
        assert manifest[dst] == {"sha256": hashlib.sha256(body).hexdigest(),
                                 "bytes": len(body)}


# -- download_dataset ---------------------------------------------------------

def _wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    import io
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((pcm * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def samples(seed: int = 0) -> list:
    """Dataset records of every shape write_sample takes: Emilia's json
    meta with an mp3 array, flat meta with an "audio" array, a stereo
    array, raw wav bytes (where the native loader builds), a record
    without any audio (an error the CLI skips), and an over-range
    signal (clipped)."""
    rng = np.random.default_rng(seed)
    sr = 16000
    out = [
        {"mp3": {"array": 0.3 * rng.standard_normal(4000),
                 "sampling_rate": sr},
         "json": {"id": "utt0", "text": "transcript 0",
                  "wav": "EN/mp3/utt0.mp3"}},
        {"audio": {"array": 0.2 * rng.standard_normal(3000),
                   "sampling_rate": 24000},
         "id": "utt1", "text": "transcript 1"},
        {"flac": {"array": 0.2 * rng.standard_normal((2, 1600)),
                  "sampling_rate": sr},
         "json": {"id": "utt2", "text": "stereo", "wav": "EN/mp3/utt2.mp3"}},
        {"json": {"id": "bad", "text": "no audio"}},
        {"mp3": {"array": 1.5 * rng.standard_normal(800),
                 "sampling_rate": sr},
         "id": "utt4", "text": "clipped", "wav": "ZH/mp3/utt4.mp3"}]
    if native_available():
        pcm = 0.25 * np.sin(2 * np.pi * 440 * np.arange(800) / sr)
        out.append({"mp3": _wav_bytes(pcm, sr),
                    "json": {"id": "raw5", "text": "raw wav bytes"}})
    return out


def _tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_write_sample_files_as_jax(tmp_path):
    for s in samples():
        got = []
        for name, dd in (("jax", j_dd), ("torch", t_dd)):
            try:
                sid, fresh, path = dd.write_sample(s, tmp_path / name)
                got.append((sid, fresh,
                            str(path.relative_to(tmp_path / name))))
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1]
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    assert "EN/utt0.wav" in _tree(tmp_path / "torch")
    sid, fresh, _ = t_dd.write_sample(samples()[0], tmp_path / "torch")
    assert (sid, fresh) == ("utt0", False)  # resumable


def test_decode_raw_wav_bytes():
    if not native_available():
        pytest.skip("the native loader does not build here")
    pcm = 0.25 * np.sin(2 * np.pi * 440 * np.arange(800) / 16000)
    s = {"mp3": _wav_bytes(pcm, 16000)}
    ours, theirs = t_dd._decode(s), j_dd._decode(s)
    assert ours[1] == theirs[1] == 16000
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_allclose(ours[0], pcm.astype(np.float32), atol=1e-3)


def test_download_dataset_main_as_jax(tmp_path, monkeypatch, capsys):
    seen = []

    def load_dataset(name, subset, split, streaming):
        seen.append((name, subset, split, streaming))
        return iter(samples())

    stub = types.ModuleType("datasets")
    stub.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", stub)
    lists = {}
    for name, dd in (("jax", j_dd), ("torch", t_dd)):
        out = tmp_path / name
        dd.main(["--dataset", "amphion/Emilia-Dataset", "--subset", "EN",
                 "--out_dir", str(out), "--max_samples", "5",
                 "--data_list", str(tmp_path / f"{name}.list")])
        lists[name] = (tmp_path / f"{name}.list").read_text().replace(
            str(out), "OUT")
    assert seen == [("amphion/Emilia-Dataset", "EN", "train", True)] * 2
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    assert lists["torch"] == lists["jax"]
    assert lists["torch"].splitlines() == [
        "OUT/EN/utt0.wav", "OUT/utt1.wav", "OUT/EN/utt2.wav",
        "OUT/ZH/utt4.wav"]
    assert "done: 4 written, 0 existing, 1 errors" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(SystemExit, match="datasets"):
        t_dd.main(["--dataset", "x", "--out_dir", str(tmp_path / "none")])


# -- the functions the twin modules lacked ------------------------------------

def test_fsq_digits_and_centers_exact():
    codes = np.random.default_rng(5).integers(0, t_fsq.CODEBOOK_SIZE,
                                              (4, 33))
    for c in (codes.astype(np.int32),):
        ref = np.asarray(j_fsq.fsq_digits(jnp.asarray(c)))
        ours = t_fsq.fsq_digits(torch.as_tensor(c)).numpy()
        assert ours.dtype == ref.dtype and ours.shape == (4, 33, 8)
        np.testing.assert_array_equal(ours, ref)
        ref_c = np.asarray(j_fsq.fsq_centers(jnp.asarray(c)))
        ours_c = t_fsq.fsq_centers(torch.as_tensor(c)).numpy()
        assert ours_c.dtype == ref_c.dtype == np.float32
        np.testing.assert_array_equal(ours_c, ref_c)
    # the digits invert fsq_encode
    h = torch.as_tensor(np.random.default_rng(6).standard_normal((50, 8)))
    centers = t_fsq.fsq_centers(t_fsq.fsq_encode(h))
    np.testing.assert_array_equal(centers.numpy(),
                                  torch.round(torch.tanh(h.float())
                                              * t_fsq.FSQ_SCALE).numpy())


def test_make_pad_mask_exact():
    lengths = np.random.default_rng(7).integers(0, 20, 9)
    for max_len in (1, 13, 25):
        ref = np.asarray(j_masks.make_pad_mask(jnp.asarray(lengths), max_len))
        ours = t_masks.make_pad_mask(torch.as_tensor(lengths), max_len)
        np.testing.assert_array_equal(ours.numpy(), ref)


def test_mpg123_available_as_jax():
    assert t_mp3.mpg123_available() == j_mp3.mpg123_available()
    assert t_mp3.mpg123_available() == (t_mp3._lib() is not None)


def test_profile_writes_a_trace(tmp_path):
    with t_logging.profile(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    json.loads(traces[0].read_text())


@pytest.mark.parametrize("name", ["constant", "squareroot_constant"])
def test_constant_schedules_match_jax(name):
    make = {"constant": lambda m: m.constant(3e-4),
            "squareroot_constant": lambda m: m.squareroot_constant(
                0.05, 400, min_lr=1e-5)}[name]
    ours, ref = make(t_sched), make(j_sched)
    for step in (0, 1, 399, 400, 401, 10_000, 10 ** 8):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   err_msg=f"{name} @ {step}")


# -- the file lists -----------------------------------------------------------

# .py files of the JAX package with no twin in the port, and why
NO_TWIN = {
    "ops/safe_conv.py": "works around a TPU autodiff fault in strided and "
                        "transposed convs (its docstring); the port uses "
                        "torch's Conv1d and ConvTranspose1d",
    "utils/compile_cache.py": "points XLA's persistent compile cache at a "
                              "directory; the port's persisted artifacts "
                              "are the kernel libraries in build/kernels/ "
                              "(kernels/build.py)",
}


def test_every_jax_module_has_a_twin():
    jax_files = {str(p.relative_to(REPO / "minimax_speech_tpu"))
                 for p in (REPO / "minimax_speech_tpu").rglob("*.py")}
    port_files = {str(p.relative_to(REPO / "minimax_speech_torch"))
                  for p in (REPO / "minimax_speech_torch").rglob("*.py")}
    missing = jax_files - port_files
    assert missing == set(NO_TWIN), (
        f"JAX modules without a twin or a stated reason: "
        f"{sorted(missing - set(NO_TWIN))}; listed but ported or gone: "
        f"{sorted(set(NO_TWIN) - missing)}")
