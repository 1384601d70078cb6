"""Overfit-and-synthesize proof on the port: the system learns and speaks.

Port of scripts/overfit_pipeline.py. The reference's success criteria
("LLM acc >95%, flow recon <0.1", README.md) on a deterministic
mini-corpus, entirely through the port's CLIs:

  corpus -> extract_fsq (S3) -> train_dac -> extract_dac_latents
         -> train flow (+ an lr/10 polish) -> train LM
         -> TTS.inference_zero_shot

then `evaluate` checks, through the real inference surfaces, that the
trained system reproduces its training data: (a) the LM continues the
held-in ground-truth tokens, (b) the flow reconstructs the held-in
latents (one draw and the 4-draw posterior mean), (c) the synthesized
waveform carries the training audio's content, (d) the codec's SNR.
With held-out utterances (n_speakers > 1), `evaluate_zero_shot` scores
true zero-shot synthesis from re-tokenized prompts and unseen text.

Every stage runs on one device, CUDA unless --device names another:

  python -m minimax_speech_torch.cli.overfit_pipeline --workdir W --fresh
  python -m minimax_speech_torch.cli.overfit_pipeline --workdir W \\
      --device cpu --n_utts 2 --dac_iters 2 --flow_epochs 2 \\
      --flow_polish_epochs 1 --llm_epochs 2

A stage whose outputs exist is skipped (stage-level resume), as in the
JAX script. The S3 tokenizer's weights are random from a seeded
torch.Generator: they define the token vocabulary, and determinism is
what matters. The random draws that the JAX script takes from
PRNGKey(0) (the LM decode) and PRNGKey(100) splits (the flow's extra
draws) are host noise here, from seeded CPU generators moved to the
device, so the card and the CPU draw the same numbers; or the caller
gives them (`evaluate`'s `flow_noises`, `gumbel_top`, `gumbel_fallback`).
The zero-shot syntheses draw from `TTS`'s generator on the device, as
the JAX script's from its key. Prints one JSON line of metrics, with
the JAX script's keys.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import wave
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]

# one shared pentatonic "voice": fixed harmonic timbre, per-segment melody
_NOTES = np.array([146.83, 164.81, 196.0, 220.0, 246.94, 293.66])
_HARMONICS = ((1, 0.55), (2, 0.28), (3, 0.14), (4, 0.07))
_WORDS = ["do", "re", "mi", "fa", "so", "la"]
# the seeds of the S3 tokenizer's weights and of the draws JAX takes from
# PRNGKey(0) (the LM decode, the zero-shot calls) and PRNGKey(100) (the
# flow's three extra draws)
S3_SEED, DECODE_SEED, FLOW_DRAW_SEED = 0, 0, 100


def _segment_notes(rng: np.random.Generator, n_notes: int) -> np.ndarray:
    return rng.integers(0, len(_NOTES), size=n_notes)


def _speaker_profile(s: int, n_speakers: int) -> dict | None:
    """Deterministic per-speaker voice signature of the multi-speaker
    corpus: pitch register (a 2^(1/3) ladder, shifted 1.1x so the lowest
    f0 stays above ~70 Hz), harmonic recipe (decay and even-harmonic
    tilt) and vibrato, recoverable from a short prompt."""
    if n_speakers <= 1:
        return None
    ratio = 1.1 * 2.0 ** ((s - (n_speakers - 1) / 2) / 3.0)
    alpha = (0.35, 0.55, 0.75, 0.95)[s % 4]     # harmonic decay
    tilt = 1.6 if s % 2 else 0.6                 # even-harmonic emphasis
    raw = [alpha ** h * (tilt if (h + 1) % 2 == 0 else 1.0)
           for h in range(4)]
    tot = sum(raw)
    # normalized to the single voice's total amplitude (1.04)
    harmonics = tuple((h + 1, 1.04 * a / tot) for h, a in enumerate(raw))
    return {"ratio": ratio, "harmonics": harmonics,
            "vib_rate": 3.5 + 0.9 * s,
            "vib_depth": (0.0, 0.012, 0.02)[s % 3]}


def _synth(note_idx: np.ndarray, seconds: float, sr: int,
           profile: dict | None = None) -> np.ndarray:
    """Deterministic closed-form melody (the same content at any sample
    rate, so 16 kHz prompts are exact, not resampled)."""
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    per = seconds / len(note_idx)
    f0 = _NOTES[note_idx[np.minimum((t / per).astype(int),
                                    len(note_idx) - 1)]]
    harmonics = _HARMONICS
    if profile is not None:
        f0 = f0 * profile["ratio"]
        if profile["vib_depth"]:
            f0 = f0 * (1.0 + profile["vib_depth"]
                       * np.sin(2 * np.pi * profile["vib_rate"] * t))
        harmonics = profile["harmonics"]
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = np.zeros(n)
    for h, a in harmonics:
        x += a * np.sin(h * phase)
    # soft attack/release so segment boundaries aren't clicks
    env = np.minimum(1.0, np.minimum(t, seconds - t) / 0.02)
    return (0.6 * x * env).astype(np.float32)


def _text_for(note_idx: np.ndarray, idx: int, part: str) -> str:
    melody = " ".join(_WORDS[i] for i in note_idx)
    return f"utterance {_WORDS[idx % len(_WORDS)]} part {part} {melody}"


def _training_text(text_a: str, text_b: str) -> str:
    """The exact text zero-shot inference feeds the LM: the normalized
    prompt text, then the normalized text with its terminal period, with
    no separator (the pipeline concatenates the two token runs)."""
    return f"{text_a}{text_b}."


def _write_wav(path: Path, audio: np.ndarray, sr: int):
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def make_corpus(out_dir: Path, n_utts: int = 4, seg_seconds: float = 1.2,
                sr: int = 24000, seed: int = 7, n_notes: int = 6,
                n_speakers: int = 1,
                holdout_per_speaker: int = 0,
                n_extra_texts: int = 0) -> dict:
    """Each utterance is segment A then segment B, so a zero-shot call
    (prompt A, text B's transcript) is exactly a training continuation.

    n_speakers > 1: utterances go round-robin to the speakers'
    voices with speaker-free texts, and the last holdout_per_speaker of
    each speaker stay out of data.list (held-out evaluation only); each
    trained utterance's segment A is a sample of its own (the prompt as
    zero-shot inference tokenizes it alone). n_extra_texts: LM-only
    utterances (llm.list), drawn after the main ones so that those stay
    byte-identical. Returns the metadata: per-utterance notes, texts,
    speaker and holdout flag, and the lists."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    meta = {"sr": sr, "seg_seconds": seg_seconds, "utts": [],
            "n_speakers": n_speakers}
    paths, train_paths, seg_paths = [], [], []
    per_speaker = n_utts // max(n_speakers, 1)
    for i in range(n_utts):
        spk = i % n_speakers
        # round-robin: utterance i is this speaker's (i // n_speakers)-th
        nth = i // n_speakers
        holdout = (holdout_per_speaker > 0
                   and nth >= per_speaker - holdout_per_speaker)
        profile = _speaker_profile(spk, n_speakers)
        na = _segment_notes(rng, n_notes)
        nb = _segment_notes(rng, n_notes)
        a = _synth(na, seg_seconds, sr, profile)
        b = _synth(nb, seg_seconds, sr, profile)
        p = out_dir / f"utt{i}.wav"
        _write_wav(p, np.concatenate([a, b]), sr)
        if n_speakers > 1:
            text_a = "say part one " + " ".join(_WORDS[j] for j in na)
        else:
            text_a = _text_for(na, i, "one")
        text_b = "and part two goes " + " ".join(_WORDS[j] for j in nb)
        (out_dir / f"utt{i}.txt").write_text(_training_text(text_a, text_b))
        meta["utts"].append({"wav": str(p), "notes_a": na.tolist(),
                             "notes_b": nb.tolist(), "text_a": text_a,
                             "text_b": text_b, "speaker": spk,
                             "holdout": holdout})
        paths.append(str(p))
        if not holdout:
            train_paths.append(str(p))
            if n_speakers > 1:
                ps = out_dir / f"utt{i}a.wav"
                _write_wav(ps, a, sr)
                ps.with_suffix(".txt").write_text(f"{text_a}.")
                seg_paths.append(str(ps))
    extra_paths, extra_seg_paths = [], []
    for j in range(n_extra_texts):
        spk = j % max(n_speakers, 1)
        profile = _speaker_profile(spk, n_speakers)
        na = _segment_notes(rng, n_notes)
        nb = _segment_notes(rng, n_notes)
        a = _synth(na, seg_seconds, sr, profile)
        b = _synth(nb, seg_seconds, sr, profile)
        p = out_dir / f"utt_x{j}.wav"
        _write_wav(p, np.concatenate([a, b]), sr)
        if n_speakers > 1:
            text_a = "say part one " + " ".join(_WORDS[i] for i in na)
        else:
            text_a = _text_for(na, n_utts + j, "one")
        text_b = "and part two goes " + " ".join(_WORDS[i] for i in nb)
        p.with_suffix(".txt").write_text(_training_text(text_a, text_b))
        extra_paths.append(str(p))
        ps = out_dir / f"utt_x{j}a.wav"
        _write_wav(ps, a, sr)
        ps.with_suffix(".txt").write_text(f"{text_a}.")
        extra_seg_paths.append(str(ps))
    lst = out_dir / "data.list"
    lst.write_text("\n".join(train_paths + seg_paths))
    all_lst = out_dir / "all.list"
    all_lst.write_text("\n".join(paths + seg_paths + extra_paths
                                 + extra_seg_paths))
    meta["list"] = str(lst)
    meta["all_list"] = str(all_lst)
    if n_extra_texts:
        lm_lst = out_dir / "llm.list"
        lm_lst.write_text("\n".join(train_paths + seg_paths + extra_paths
                                    + extra_seg_paths))
        meta["lm_list"] = str(lm_lst)
    return meta


def _read_metric(model_dir: Path, name: str, key: str) -> float:
    rows = [json.loads(line) for line in
            (model_dir / f"{name}_metrics.jsonl").read_text().splitlines()]
    vals = [r[key] for r in rows if key in r]
    return float(vals[-1]) if vals else float("nan")


def _xcorr_peak(x: np.ndarray, y: np.ndarray, max_lag: int) -> float:
    """Peak normalized cross-correlation of x vs y over +-max_lag."""
    n = min(len(x), len(y))
    x = x[:n] - x[:n].mean()
    y = y[:n] - y[:n].mean()
    best = -1.0
    for lag in range(-max_lag, max_lag + 1, max(max_lag // 40, 1)):
        if lag >= 0:
            a, b = x[lag:], y[: n - lag]
        else:
            a, b = x[: n + lag], y[-lag:]
        denom = np.sqrt((a * a).sum() * (b * b).sum()) + 1e-12
        best = max(best, float((a * b).sum() / denom))
    return best


def _log_mels(x: np.ndarray, y: np.ndarray):
    """The HiFi-GAN log-mels (80, T) of x and y over their common length,
    cut to their common frame count (float32 on the CPU)."""
    import torch

    from minimax_speech_torch.ops import mel as mel_ops

    n = min(len(x), len(y))
    mx, my = (mel_ops.hifigan_log_mel(torch.as_tensor(
        np.asarray(a[:n], np.float32))).numpy() for a in (x, y))
    t = min(mx.shape[1], my.shape[1])
    return mx[:, :t], my[:, :t]


def _mel_spectral_l1(x: np.ndarray, y: np.ndarray) -> float:
    """Normalized log-mel L1 of x vs y (the reference's "mel spectral
    loss" flow bar): mean |mel(x) - mel(y)| over the mean absolute
    deviation of mel(y), so 0.05 means an error of 5% of the target's
    own spectral variation."""
    mx, my = _log_mels(x, y)
    dev = np.abs(my - my.mean()).mean() + 1e-12
    return float(np.abs(mx - my).mean() / dev)


def _mel_content_match(x: np.ndarray, y: np.ndarray) -> tuple:
    """Phase-insensitive content similarity -> (mel_dev_corr, pitch_acc):
    the correlation of the log-mels with each bin's temporal mean
    removed (the shared timbre alone scores high on raw log-mels), and
    the share of frames whose loudest mel bin (the pitch track) agrees."""
    mx, my = _log_mels(x, y)
    dx = mx - mx.mean(axis=1, keepdims=True)
    dy = my - my.mean(axis=1, keepdims=True)
    a, b = dx.ravel(), dy.ravel()
    dev = float((a * b).sum() /
                (np.sqrt((a * a).sum() * (b * b).sum()) + 1e-12))
    acc = float((mx.argmax(0) == my.argmax(0)).mean())
    return dev, acc


def overfit_overrides() -> list[str]:
    """tiny.yaml's overrides for the proof (as the JAX script sets them):
    byte-tokenizer text is ~1.2 characters a speech token, so the
    reference's 2x/20x length ratios do not fit; a 16/128 codec (4/32
    leaves the last decoder block 1-2 channels); a 96-channel UNet (at 32
    channels, below the 80-dim latent, the velocity field is
    rank-limited); the conditional reconstruction path without CFG
    dropout, inference CFG or the contrastive loss."""
    return ["model.min_token_text_ratio=0.1",
            "model.max_token_text_ratio=2.0",
            "model.max_speech_tokens=48",
            "model.flow.n_timesteps=10",
            "model.dac.encoder_dim=16",
            "model.dac.decoder_dim=128",
            "model.flow.unet.channels=[96]",
            "model.flow.cfm.training_cfg_rate=0.0",
            "model.flow.cfm.inference_cfg_rate=0.0",
            "model.flow.cfm.use_contrastive_fm=false"]


def lm_overrides(lm_hidden: int = 0, lm_layers: int = 0) -> list[str]:
    """The larger Stage-1 LM of the zero-shot proof: width lm_hidden with
    4 heads of lm_hidden // 4 and a 2x MLP; depth lm_layers (0: the
    config's)."""
    out = []
    if lm_hidden:
        out += [f"model.lm.llm_input_size={lm_hidden}",
                f"model.lm.llm_output_size={lm_hidden}",
                f"model.lm.qwen.hidden_size={lm_hidden}",
                f"model.lm.qwen.head_dim={lm_hidden // 4}",
                f"model.lm.qwen.intermediate_size={2 * lm_hidden}"]
    if lm_layers:
        out.append(f"model.lm.qwen.n_layers={lm_layers}")
    return out


def run(workdir: Path, n_utts: int = 4, seg_seconds: float = 1.2,
        dac_iters: int = 1500, flow_epochs: int = 8000,
        flow_polish_epochs: int = 1500, llm_epochs: int = 300,
        llm_lr: float = 1e-3, flow_lr: float = 2e-3, dac_lr: float = 5e-4,
        resume: bool = True, n_speakers: int = 1,
        holdout_per_speaker: int = 0, n_extra_texts: int = 0,
        lm_hidden: int = 0, lm_layers: int = 0,
        hybrid_prefix: bool = False,
        config: str = str(REPO / "configs/tiny.yaml"),
        device: str = "cuda", stats: dict | None = None) -> dict:
    """Every stage through the port's CLIs on `device`, then `evaluate`
    (and `evaluate_zero_shot` with held-out utterances). Returns the
    metrics. stats, when given, gets each stage that ran: its wall
    seconds ("s") and the attention kernels' launches in it ("k1", K2's
    "k2_fwd" and "k2_bwd"; 0 on the CPU, where the plain versions run)."""
    import torch
    import yaml

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.cli import (extract_dac_latents, extract_fsq,
                                          train as train_cli, train_dac)
    from minimax_speech_torch.models import s3tokenizer as s3
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.device import resolve_device

    resolve_device(device)  # no CUDA and none asked for: raise first
    stats = {} if stats is None else stats
    dev = ["--device", device]
    workdir = Path(workdir)
    corpus = workdir / "corpus"
    model_dir = workdir / "model"
    model_dir.mkdir(parents=True, exist_ok=True)
    meta = make_corpus(corpus, n_utts=n_utts, seg_seconds=seg_seconds,
                       n_speakers=n_speakers,
                       holdout_per_speaker=holdout_per_speaker,
                       n_extra_texts=n_extra_texts)
    data = cfg_lib.apply_overrides(cfg_lib.load_yaml(config),
                                   overfit_overrides()
                                   + lm_overrides(lm_hidden, lm_layers))
    cfg_path = model_dir / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(data))
    tts_cfg = cfg_lib.build_tts_config(data["model"])

    def stage_done(*outputs) -> bool:
        # stage-level resume: a crash loses only the stage in flight
        return resume and all(Path(o).exists() for o in outputs)

    def timed(name, fn):
        stats[name] = stage_stats(fn)[1]

    # 1. S3 tokenizer: seeded weights define the token vocabulary;
    # features for every utterance (holdouts too: extraction is not
    # training), so a resumed workdir with new extras re-extracts exactly
    # the missing sidecars
    all_list = meta.get("all_list", meta["list"])
    all_paths = [line for line in Path(all_list).read_text().splitlines()
                 if line]
    fsq_files = [str(Path(w).with_suffix("")) + "_fsq.npy"
                 for w in all_paths]
    if not stage_done(model_dir / "s3.npz", *fsq_files):
        s3_model = s3.S3TokenizerV2(tts_cfg.s3)
        params_io.init_params(s3_model,
                              torch.Generator().manual_seed(S3_SEED))
        params_io.save_params(str(model_dir / "s3.npz"), s3_model)
        timed("extract_fsq", lambda: extract_fsq.main(
            ["--file_list", all_list, "--ckpt", str(model_dir / "s3.npz"),
             "--config", str(cfg_path), *dev]))

    # 2. DAC-VAE: pure waveform-L1 (+KL) reconstruction, the GAN never
    # engaged (a handful of utterances lets the discriminator win long
    # before the generator fits; log-magnitude terms trap near-silent
    # output), as the JAX script trains it
    if not stage_done(model_dir / "codec.npz"):
        timed("train_dac", lambda: train_dac.main([
            "--train_folders", str(corpus), "--model_dir",
            str(workdir / "exp_dac"), "--config", str(cfg_path),
            "--batch_size", "2", "--duration", "0.38",
            "--num_iters", str(dac_iters), "--save_iters", "200",
            "--log_interval", "50", "--lr", str(dac_lr),
            "--gan_start_step", str(10 ** 9), "--warmup_steps", "100",
            "--lambda_waveform", "50.0", "--lambda_stft", "0.0",
            "--lambda_mel", "0.0", "--grad_clip", "1.0",
            "--augment_prob", "0.0", "--sample_freq", str(10 * dac_iters),
            "--export_npz", str(model_dir / "codec.npz"), *dev]))

    # 3. latents from the trained codec; the standardization stats from
    # the train list only, then the held-out sidecars without stats
    lat_files = [str(Path(w).with_suffix("")) + "_latent2x.npz"
                 for w in all_paths]
    stats_path = model_dir / "latent_stats.json"
    if not stage_done(stats_path, *lat_files):
        def latents():
            extract_dac_latents.main(
                ["--file_list", meta["list"],
                 "--ckpt", str(model_dir / "codec.npz"),
                 "--config", str(cfg_path), "--stats_out", str(stats_path),
                 "--verify_fraction", "0", *dev])
            if all_list != meta["list"]:
                extract_dac_latents.main(
                    ["--file_list", all_list, "--skip_existing",
                     "--ckpt", str(model_dir / "codec.npz"),
                     "--config", str(cfg_path), "--verify_fraction", "0",
                     "--stats_out", "", *dev])
        timed("extract_dac_latents", latents)

    # 3b. hybrid-prefix LM samples (LM only): the standalone segment-A
    # tokens, then the full utterance's tokens past them, under the full
    # text: the conditional zero-shot inference decodes
    if hybrid_prefix and "lm_list" in meta:
        _hybrid_samples(Path(meta["lm_list"]))

    # the flow standardizes latents with the train list's stats
    lat = json.loads(stats_path.read_text())
    data = cfg_lib.apply_overrides(data, [
        "model.flow.latent_mean=" + json.dumps(lat["mean"]),
        "model.flow.latent_std=" + json.dumps(lat["std"])])
    cfg_path.write_text(yaml.safe_dump(data))

    # 4. flow: tokens -> latents, then a low-lr polish
    def train(model, train_list, exp, epochs, lr, log_interval, out):
        train_cli.main([
            "--model", model, "--config", str(cfg_path),
            "--train_data", train_list, "--model_dir", str(workdir / exp),
            "--max_epoch", str(epochs), "--dp", "1", "--export_npz", out,
            "--override", f"train.lr={lr}",
            "--override", "train.warmup_steps=20",
            "--override", f"train.log_interval={log_interval}",
            "--override", "train.save_per_step=100",
            *(["--override", "train.bistream_prob=0.0"]
              if model == "llm" else []), *dev])

    flow_npz = str(model_dir / "flow.npz")
    if not stage_done(model_dir / "flow.npz"):
        timed("train_flow", lambda: train(
            "flow", meta["list"], "exp_flow", flow_epochs, flow_lr, 50,
            flow_npz))
    polish_marker = model_dir / "flow_polished"
    if flow_polish_epochs and not stage_done(polish_marker):
        timed("train_flow_polish", lambda: train(
            "flow", meta["list"], "exp_flow", flow_polish_epochs,
            flow_lr / 10, 100, flow_npz))
        polish_marker.write_text("done")

    # 5. LM: text -> tokens, unistream only (the zero-shot plan's layout)
    if not stage_done(model_dir / "llm.npz"):
        timed("train_llm", lambda: train(
            "llm", meta.get("lm_list", meta["list"]), "exp_llm", llm_epochs,
            llm_lr, 50, str(model_dir / "llm.npz")))

    metrics = {
        "llm_train_acc": _read_metric(workdir / "exp_llm", "llm", "acc"),
        "llm_train_loss": _read_metric(workdir / "exp_llm", "llm", "loss"),
        "flow_train_loss": _read_metric(workdir / "exp_flow", "flow",
                                        "loss"),
    }
    got, stats["evaluate"] = stage_stats(
        lambda: evaluate(model_dir, corpus, meta, device=device))
    metrics.update(got)
    if any(u.get("holdout") for u in meta["utts"]):
        got, stats["evaluate_zero_shot"] = stage_stats(
            lambda: evaluate_zero_shot(model_dir, meta, device=device))
        metrics.update(got)
    return metrics


def stage_stats(fn):
    """(fn(), {"s": its wall seconds, "k1", "k2_fwd", "k2_bwd": the
    attention kernels' launches during it})."""
    import time

    from minimax_speech_torch.kernels import flash_attention, splash

    k1, k2 = flash_attention.launches, dict(splash.launches)
    t0 = time.perf_counter()
    out = fn()
    return out, {"s": time.perf_counter() - t0,
                 "k1": flash_attention.launches - k1,
                 "k2_fwd": splash.launches["forward"] - k2["forward"],
                 "k2_bwd": splash.launches["backward"] - k2["backward"]}


def _hybrid_samples(lm_list: Path) -> None:
    """Append to lm_list, once, a sample per utterance with a segment-A
    sidecar: tokens fsq(A alone) ++ fsq(full)[len(A):], text and audio
    the full utterance's (its latents copied: the LM's batches never read
    them, the opener needs the file)."""
    lm_paths = [line for line in lm_list.read_text().splitlines() if line]
    hybrids = []
    for w in list(lm_paths):
        stem = Path(w).with_suffix("")
        seg = Path(str(stem) + "a.wav")
        if not seg.exists() or str(stem).endswith("a"):
            continue
        fsq_a = np.load(str(stem) + "a_fsq.npy")
        fsq_f = np.load(str(stem) + "_fsq.npy")
        la = min(len(fsq_a), len(fsq_f))
        hyb = np.concatenate([fsq_a[:la], fsq_f[la:]])
        h = Path(str(stem) + "h.wav")
        if not h.exists():
            shutil.copyfile(w, h)
            shutil.copyfile(str(stem) + ".txt", str(stem) + "h.txt")
            shutil.copyfile(str(stem) + "_latent2x.npz",
                            str(stem) + "h_latent2x.npz")
        np.save(str(stem) + "h_fsq.npy", hyb.astype(np.int32))
        hybrids.append(str(h))
    if hybrids and not lm_paths[-1].endswith("h.wav"):
        lm_list.write_text("\n".join(lm_paths + hybrids))


def ground_truth(wav: str):
    """An utterance's sidecars: (FSQ tokens, 2x latents) cut to n tokens
    and 2n frames, and k = n // 2, the held-in prompt's tokens."""
    stem = Path(wav).with_suffix("")
    gt_tok = np.load(str(stem) + "_fsq.npy")
    gt_lat = np.load(str(stem) + "_latent2x.npz")["mu"]
    n = min(len(gt_tok), gt_lat.shape[0] // 2)
    return gt_tok[:n], gt_lat[: 2 * n], n // 2


def flow_draws(shape, n: int, device) -> list:
    """n extra start noises of `shape` for the flow: host noise from a
    CPU generator seeded FLOW_DRAW_SEED, on `device` (the JAX script
    splits PRNGKey(100) for them)."""
    import torch

    gen = torch.Generator().manual_seed(FLOW_DRAW_SEED)
    return [torch.randn(shape, generator=gen).to(device) for _ in range(n)]


def evaluate(model_dir: Path, corpus: Path, meta: dict, device="cuda",
             flow_noises=None, gumbel_top=None, gumbel_fallback=None,
             draw_seed: int | None = None) -> dict:
    """Trained-weights evaluation through the real inference surfaces, on
    `device`. flow_noises: the three extra start noises of the 4-draw
    mean (the pipeline's noise table's shape), else flow_draws;
    gumbel_top / gumbel_fallback: the LM decode's noise (llm.generate),
    else host noise from a CPU generator seeded DECODE_SEED. draw_seed:
    the LM decode's noise drawn on the device from a generator seeded
    draw_seed instead, and the syntheses' seed (else DECODE_SEED)."""
    import torch

    from minimax_speech_torch.infer.api import TTS
    from minimax_speech_torch.infer.pipeline import next_bucket
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.models.flow import flow_inference

    tts = TTS(model_dir=str(model_dir), device=device)
    p = tts.pipeline
    dev = p.device
    cfg = p.cfg
    sr = meta["sr"]
    u = meta["utts"][0]
    prof = _speaker_profile(u.get("speaker", 0), meta.get("n_speakers", 1))
    gt_tok, gt_lat, k = ground_truth(u["wav"])
    n = len(gt_tok)
    wav_full = _synth(np.array(u["notes_a"] + u["notes_b"]),
                      2 * meta["seg_seconds"], sr, prof)

    # conditioning as in training: the speaker encoder on the utterance's
    # own mel
    prompt_mel = p.extract_prompt_mel(wav_full)
    lm_spk, flow_emb = p.speaker_embedding(prompt_mel)

    # (a) LM continuation of the ground-truth prefix: tokens k..n back
    text = (corpus / "utt0.txt").read_text().strip()
    full_text = np.asarray(tts.frontend.extract_text_tokens(text), np.int32)
    src, tok, plen = llm_mod.build_inference_plan(
        full_text, gt_tok[:k], use_spk=cfg.lm.use_speaker_encoder)
    pad_to = next_bucket(src.shape[1])
    src = np.pad(src, ((0, 0), (0, pad_to - src.shape[1])))
    tok = np.pad(tok, ((0, 0), (0, pad_to - tok.shape[1])))
    expect = gt_tok[k:]
    if gumbel_top is None or gumbel_fallback is None:
        gen = (torch.Generator().manual_seed(DECODE_SEED) if draw_seed is None
               else torch.Generator(device=dev).manual_seed(draw_seed))
        g_top, g_fb = llm_mod.decode_noise(
            cfg.lm, cfg.max_speech_tokens, 1, gen, gen.device)
        gumbel_top = g_top if gumbel_top is None else gumbel_top
        gumbel_fallback = g_fb if gumbel_fallback is None else gumbel_fallback

    def decode(lm):
        out, count = llm_mod.generate(
            lm, src, tok, plen, lm_spk, [2], [n - k + 8],
            max_steps=cfg.max_speech_tokens, gumbel_top=gumbel_top,
            gumbel_fallback=gumbel_fallback, device=dev)
        c = int(count[0])
        g = out[0, :c].cpu().numpy()
        m = min(len(g), len(expect))
        return (float((g[:m] == expect[:m]).mean()) if m else 0.0), c

    token_match, gen_len = decode(p.lm)
    token_len_err = abs(gen_len - len(expect))
    # (a2) W8A8 decode on the trained weights: the quality side of the
    # int8 speed/quality trade on a model that has learned
    token_match_w8a8, _ = decode(llm_mod.quantize_lm(p.lm))

    # (b) flow reconstruction from ground-truth tokens; (b2) the 4-draw
    # posterior mean, which isolates the learned conditional mean (the
    # quantity the reference's "recon < 0.1" bar speaks to)
    tok_buf = np.zeros((1, next_bucket(n)), np.int64)
    tok_buf[0, :n] = gt_tok
    tgt = gt_lat[2 * k:]
    if flow_noises is None:
        flow_noises = flow_draws(tuple(p.noise.shape), 3, dev)
    draws = []
    for noise in [p.noise, *flow_noises]:
        f = flow_inference(p.flow, tok_buf, [n], gt_lat[: 2 * k][None],
                           flow_emb, noise, device=dev)
        draws.append(f.float().cpu().numpy()[0, : 2 * (n - k)])
    feat = draws[0]
    var = float(np.var(tgt) + 1e-12)
    flow_mse = float(np.mean((feat - tgt) ** 2))
    flow_nmse = flow_mse / var
    mean4 = np.mean(draws, axis=0)
    flow_nmse_mean4 = float(np.mean((mean4 - tgt) ** 2)) / var

    def dec(z):  # latents (T, 80) -> the trained codec's waveform
        with torch.no_grad():
            return p.decode(torch.as_tensor(np.asarray(z, np.float32),
                                            device=dev)[None])[0] \
                .cpu().numpy()

    # (c) held-in reproduction through the real API: the speaker cache
    # carries the utterance's own prompt context (prompt tokens and
    # latents as extracted for training); the re-tokenized zero-shot
    # path is reported beside it as zs_*
    text_a_norm = tts.frontend.text_normalize(u["text_a"], split=False)[0]
    tts.spk2info["heldin"] = {
        "prompt_tokens": gt_tok[:k].astype(np.int32),
        "prompt_feat": gt_lat[: 2 * k].astype(np.float32),
        "lm_spk": lm_spk.float().cpu().numpy(),
        "flow_emb": flow_emb.float().cpu().numpy(),
        "prompt_text_tokens": np.asarray(
            tts.frontend.extract_text_tokens(text_a_norm), np.int32)}
    a16k = _synth(np.array(u["notes_a"]), meta["seg_seconds"], 16000, prof)
    seed = DECODE_SEED if draw_seed is None else draw_seed
    syn = np.concatenate([o["tts_speech"][0] for o in tts.inference_zero_shot(
        u["text_b"], u["text_a"], a16k, zero_shot_spk_id="heldin",
        stream=False, seed=seed)])
    syn_zs = np.concatenate([o["tts_speech"][0] for o in
                             tts.inference_zero_shot(
                                 u["text_b"], u["text_a"], a16k,
                                 stream=False, seed=seed)])
    b24k = _synth(np.array(u["notes_b"]), meta["seg_seconds"], sr, prof)
    # the oracle: ground-truth latents through the trained codec, which
    # isolates LM + flow fidelity from the codec's
    oracle = dec(tgt)
    wav_corr_oracle = _xcorr_peak(syn, oracle, max_lag=960)
    wav_corr_gt = _xcorr_peak(syn, b24k, max_lag=960)
    mel_dev_oracle, pitch_acc_oracle = _mel_content_match(syn, oracle)
    mel_dev_gt, pitch_acc_gt = _mel_content_match(syn, b24k)
    _, zs_pitch_acc_oracle = _mel_content_match(syn_zs, oracle)
    syn_mean = dec(mean4)
    mel_dev_mean4, pitch_acc_mean4 = _mel_content_match(syn_mean, oracle)
    # the reference's second flow bar ("mel spectral loss < 0.05") on the
    # posterior-mean decode
    mel_spectral_loss = _mel_spectral_l1(syn_mean, oracle)

    # (d) codec fidelity on the training audio
    rec = dec(p.extract_prompt_latent(wav_full))
    nn = min(len(rec), len(wav_full))
    err = rec[:nn] - wav_full[:nn]
    dac_snr_db = float(10 * np.log10(
        (wav_full[:nn] ** 2).mean() / (err ** 2).mean() + 1e-12))
    dac_corr = _xcorr_peak(rec, wav_full, max_lag=480)

    return {"token_match": token_match, "token_len_err": token_len_err,
            "token_match_w8a8": token_match_w8a8,
            "gen_len": gen_len, "expect_len": len(expect),
            "flow_mse": flow_mse, "flow_nmse": flow_nmse,
            "flow_nmse_mean4": flow_nmse_mean4,
            "mel_spectral_loss": mel_spectral_loss,
            "mel_dev_corr_mean4": mel_dev_mean4,
            "pitch_acc_mean4": pitch_acc_mean4,
            "wav_corr_oracle": wav_corr_oracle, "wav_corr_gt": wav_corr_gt,
            "mel_dev_corr_oracle": mel_dev_oracle,
            "mel_dev_corr_gt": mel_dev_gt,
            "pitch_acc_oracle": pitch_acc_oracle,
            "pitch_acc_gt": pitch_acc_gt,
            "dac_snr_db": dac_snr_db, "dac_corr": dac_corr,
            "syn_seconds": len(syn) / sr,
            "zs_pitch_acc_oracle": zs_pitch_acc_oracle,
            "zs_syn_seconds": len(syn_zs) / sr}


# the metrics of `evaluate` that rest on the LM decode's draw
DRAW_KEYS = ("token_match", "token_match_w8a8", "gen_len", "syn_seconds",
             "zs_syn_seconds", "wav_corr_oracle")


@contextlib.contextmanager
def _decode_tables(tables: list, replay: bool = False):
    """Until exit, every pair of decode noise tables that llm.decode_noise
    draws is appended to `tables` on the host; with `replay`, `tables` are
    handed out in order instead, on the device asked for, and every one
    must be used."""
    from minimax_speech_torch.models import llm as llm_mod

    draw = llm_mod.decode_noise
    queue = list(tables)

    def noise(cfg, max_steps, batch, generator=None, device=None):
        if not replay:
            out = draw(cfg, max_steps, batch, generator, device)
            tables.append(tuple(t.cpu() for t in out))
            return out
        g_top, g_fb = queue.pop(0)
        if tuple(g_top.shape[:2]) != (max_steps, batch):
            raise ValueError(f"replayed table {tuple(g_top.shape)} for "
                             f"{max_steps} steps x {batch}")
        return g_top.to(device), g_fb.to(device)

    llm_mod.decode_noise = noise
    try:
        yield
    finally:
        llm_mod.decode_noise = draw
    if replay and queue:
        raise ValueError(f"{len(queue)} replayed tables left unused")


def draw_sweep(model_dir: Path, corpus: Path, meta: dict, seeds,
               device="cuda") -> list:
    """`evaluate`'s DRAW_KEYS for each seed, the LM decode's noise drawn on
    `device` from a generator seeded so (`draw_seed`). Off the CPU, each
    seed runs twice more on the CPU: with the device's tables replayed
    ("cpu_replay": the device's decode is the CPU's when its keys are
    the same) and with the CPU generator's own draw ("cpu"). Returns one
    {"seed", device, ...} row a seed."""
    rows = []
    for seed in seeds:
        tables, row = [], {"seed": seed}
        with _decode_tables(tables):
            m = evaluate(model_dir, corpus, meta, device=device,
                         draw_seed=seed)
        row[device] = {k: m[k] for k in DRAW_KEYS}
        if device != "cpu":
            with _decode_tables(tables, replay=True):
                m = evaluate(model_dir, corpus, meta, device="cpu",
                             draw_seed=seed)
            row["cpu_replay"] = {k: m[k] for k in DRAW_KEYS}
            m = evaluate(model_dir, corpus, meta, device="cpu",
                         draw_seed=seed)
            row["cpu"] = {k: m[k] for k in DRAW_KEYS}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def prompt_drift(model_dir: Path, meta: dict, device="cuda") -> dict:
    """The zero-shot syntheses' prompt features in `evaluate` (utterance
    0's segment A through TTS's S3 tokenizer, codec encoder and speaker
    encoder) on `device` against the CPU's: the S3 tokens that differ and
    the largest |diff| of the prompt latents and of the speaker
    conditioning, with cuDNN's TF32 convolutions on (PyTorch's default)
    and off."""
    import torch

    from minimax_speech_torch.infer.api import TTS

    u = meta["utts"][0]
    prof = _speaker_profile(u.get("speaker", 0), meta.get("n_speakers", 1))
    a16k = _synth(np.array(u["notes_a"]), meta["seg_seconds"], 16000, prof)
    ref = TTS(model_dir=str(model_dir), device="cpu")._prompt_features(a16k)
    tts = TTS(model_dir=str(model_dir), device=device)
    saved, out = torch.backends.cudnn.allow_tf32, {}
    try:
        for name, tf32 in (("cudnn_tf32", True), ("cudnn_fp32", False)):
            torch.backends.cudnn.allow_tf32 = tf32
            got = tts._prompt_features(a16k)
            tok, want = got["prompt_tokens"], ref["prompt_tokens"]
            n = min(len(tok), len(want))
            out[name] = {
                "tokens": [len(tok), len(want)],
                "tokens_differ": int((tok[:n] != want[:n]).sum()),
                **{f"{k}_max_abs": float(np.abs(got[k] - ref[k]).max())
                   for k in ("prompt_feat", "lm_spk", "flow_emb")}}
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out


def evaluate_zero_shot(model_dir: Path, meta: dict, max_utts: int = 8,
                       device="cuda") -> dict:
    """True zero-shot evaluation: held-out utterances, re-tokenized
    prompts, unseen text, with no speaker cache. For each held-out
    utterance: prompt = its segment A at 16 kHz, text = its segment-B
    transcript; content scored against the oracle decode of its
    ground-truth latents, EOS against the known segment length."""
    import torch

    from minimax_speech_torch.infer.api import TTS

    tts = TTS(model_dir=str(model_dir), device=device)
    p = tts.pipeline
    sr = meta["sr"]
    seg = meta["seg_seconds"]
    holdouts = [u for u in meta["utts"] if u.get("holdout")][:max_utts]
    per = []
    for u in holdouts:
        profile = _speaker_profile(u["speaker"], meta["n_speakers"])
        _, gt_lat, k = ground_truth(u["wav"])
        a16k = _synth(np.array(u["notes_a"]), seg, 16000, profile)
        syn = np.concatenate([o["tts_speech"][0] for o in
                              tts.inference_zero_shot(
                                  u["text_b"], u["text_a"], a16k,
                                  stream=False, seed=DECODE_SEED)])
        with torch.no_grad():
            oracle = p.decode(torch.as_tensor(
                gt_lat[2 * k:], device=p.device)[None])[0].cpu().numpy()
        b24k = _synth(np.array(u["notes_b"]), seg, sr, profile)
        mel_dev, pitch = _mel_content_match(syn, oracle)
        mel_dev_gt, pitch_gt = _mel_content_match(syn, b24k)
        rel_len_err = abs(len(syn) / sr - seg) / seg
        per.append({"utt": Path(u["wav"]).stem, "speaker": u["speaker"],
                    "pitch_acc": pitch, "mel_dev_corr": mel_dev,
                    "pitch_acc_gt": pitch_gt,
                    "mel_dev_corr_gt": mel_dev_gt,
                    "wav_corr_gt": _xcorr_peak(syn, b24k, max_lag=960),
                    "syn_seconds": len(syn) / sr,
                    "rel_len_err": rel_len_err})

    def mean(key):
        return float(np.mean([r[key] for r in per]))

    return {"zs_pitch_acc": mean("pitch_acc"),
            "zs_mel_dev_corr": mean("mel_dev_corr"),
            "zs_pitch_acc_gt": mean("pitch_acc_gt"),
            "zs_wav_corr_gt": mean("wav_corr_gt"),
            "zs_rel_len_err": mean("rel_len_err"),
            "zs_eos_ok": float(np.mean([r["rel_len_err"] < 0.25
                                        for r in per])),
            "zs_n_holdout": len(per),
            "zs_per_utt": per}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", type=str, required=True)
    ap.add_argument("--n_utts", type=int, default=4)
    ap.add_argument("--n_speakers", type=int, default=1)
    ap.add_argument("--holdout_per_speaker", type=int, default=0)
    ap.add_argument("--n_extra_texts", type=int, default=0,
                    help="LM-only augmentation utterances (text->token "
                         "compositional coverage; flow/DAC unaffected)")
    ap.add_argument("--lm_hidden", type=int, default=0,
                    help="override the Stage-1 LM width (0 = config)")
    ap.add_argument("--lm_layers", type=int, default=0,
                    help="override the Stage-1 LM depth (0 = config)")
    ap.add_argument("--hybrid_prefix", action="store_true",
                    help="LM-only samples with the exact zero-shot "
                         "conditional: standalone-A token prefix ++ "
                         "joint-B continuation under the full text")
    ap.add_argument("--dac_iters", type=int, default=1500)
    ap.add_argument("--flow_epochs", type=int, default=8000)
    ap.add_argument("--flow_polish_epochs", type=int, default=1500)
    ap.add_argument("--llm_epochs", type=int, default=300)
    ap.add_argument("--fresh", action="store_true",
                    help="wipe the workdir first")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--stats", type=str, default=None,
                    help="write each stage's wall seconds and attention "
                         "kernel launches to this JSON")
    ap.add_argument("--draw_seeds", type=int, default=0,
                    help="then evaluate again under N decode draws "
                         "(draw_sweep: seeds 0..N-1 on the device; off "
                         "the CPU also on the CPU, and prompt_drift), one "
                         "JSON line each")
    args = ap.parse_args(argv)
    from minimax_speech_torch.utils.device import resolve_device
    resolve_device(args.device)
    wd = Path(args.workdir)
    if args.fresh and wd.exists():
        shutil.rmtree(wd)
    stats = {}
    metrics = run(wd, n_utts=args.n_utts, dac_iters=args.dac_iters,
                  flow_epochs=args.flow_epochs,
                  flow_polish_epochs=args.flow_polish_epochs,
                  llm_epochs=args.llm_epochs,
                  n_speakers=args.n_speakers,
                  holdout_per_speaker=args.holdout_per_speaker,
                  n_extra_texts=args.n_extra_texts,
                  lm_hidden=args.lm_hidden, lm_layers=args.lm_layers,
                  hybrid_prefix=args.hybrid_prefix, device=args.device,
                  stats=stats)
    if args.stats:
        Path(args.stats).write_text(json.dumps(stats))
    print(json.dumps(metrics))
    if args.draw_seeds:
        meta = make_corpus(wd / "corpus", n_utts=args.n_utts,
                           n_speakers=args.n_speakers,
                           holdout_per_speaker=args.holdout_per_speaker,
                           n_extra_texts=args.n_extra_texts)
        draw_sweep(wd / "model", wd / "corpus", meta,
                   range(args.draw_seeds), device=args.device)
        if args.device != "cpu":
            print(json.dumps({"prompt_drift": prompt_drift(
                wd / "model", meta, device=args.device)}))
    return metrics


if __name__ == "__main__":
    main()
