"""flowae eval suites and artifact logging.

Port of minimax_speech_tpu/flowae/evaluate.py: the autoencoder eval (L1,
SNR and spectral convergence over held-out batches, dumping wav samples
to `cache/audio_{gen,gt}/`), the ZDM eval (an unconditional sample per
held-out batch, its L1 against the batch) and the visualize passes
(random reconstructions or generations as wavs, with spectrogram
figures when matplotlib is there). Spectral convergence uses the
Spectrogram(n_fft=1024, hop=256, power=2) convention.

The decode noise of each batch is drawn from a torch.Generator, where
the JAX package splits a key.
"""
from __future__ import annotations

import math
import os
from typing import Iterable, Optional

import numpy as np
import torch

from minimax_speech_torch.flowae.dito import DiToAudio, dito_decode
from minimax_speech_torch.flowae.zdm import ZDMNet, zdm_generate
from minimax_speech_torch.ops import mel as mel_ops
from minimax_speech_torch.utils.device import module_device


def power_spectrogram(audio: torch.Tensor, n_fft: int = 1024,
                      hop: int = 256) -> torch.Tensor:
    """torchaudio Spectrogram(power=2) conventions: centred reflect pad,
    periodic Hann window. audio: (B, T) -> (B, frames, n_fft // 2 + 1)."""
    x = mel_ops.reflect_pad(audio, n_fft // 2)
    frames = mel_ops.frame_signal(x, n_fft, hop)
    win = mel_ops.hann_window(n_fft, audio.dtype, audio.device)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def batch_audio_metrics(ref: torch.Tensor, rec: torch.Tensor) -> dict:
    """L1, SNR and spectral convergence of one batch of (B, T) mono
    waveforms."""
    l1 = torch.mean(torch.abs(rec - ref))
    sig = torch.mean(ref ** 2)
    noise = torch.mean((rec - ref) ** 2)
    snr = 10.0 * torch.log10(sig / (noise + 1e-8))
    s_ref = power_spectrogram(ref)
    s_rec = power_spectrogram(rec)
    sc = (torch.linalg.vector_norm(s_ref - s_rec)
          / (torch.linalg.vector_norm(s_ref) + 1e-8))
    return {"L1_Loss": l1, "SNR": snr, "Spectral_Convergence": sc}


class Averager:
    """Running weighted mean."""

    def __init__(self):
        self.v, self.n = 0.0, 0

    def add(self, v: float, n: int = 1):
        self.v = (self.v * self.n + float(v) * n) / (self.n + n)
        self.n += n

    def item(self) -> float:
        return self.v


def _dump_wavs(save_dir: str, sub: str, start_idx: int,
               audio: np.ndarray, sr: int, max_samples: int) -> int:
    """Write up to 5 per batch into save_dir/cache/<sub>/. Returns the
    samples written."""
    from minimax_speech_torch.cli.synthesize import write_wav
    d = os.path.join(save_dir, "cache", sub)
    os.makedirs(d, exist_ok=True)
    wrote = 0
    for i in range(min(audio.shape[0], 5)):
        idx = start_idx + i
        if idx >= max_samples:
            break
        write_wav(os.path.join(d, f"{idx}.wav"), audio[i], sr)
        wrote += 1
    return wrote


@torch.no_grad()
def evaluate_audio_ae(model: DiToAudio, batches: Iterable[np.ndarray],
                      generator: torch.Generator,
                      n_steps: Optional[int] = None,
                      save_dir: Optional[str] = None,
                      sample_rate: int = 24000,
                      max_samples: int = 1000) -> dict:
    """The autoencoder eval: encode and render each held-out (B, T, 1)
    batch (the start noise from `generator`), average L1, SNR and
    spectral convergence, optionally dump gen/gt wavs."""
    dev = module_device(model)
    avgs = {k: Averager() for k in
            ("L1_Loss", "SNR", "Spectral_Convergence")}
    dumped = 0
    for audio in batches:
        audio = torch.as_tensor(np.asarray(audio), device=dev)
        _, mu, _ = model.encode(audio)
        rec = dito_decode(model, mu, audio.shape[1], generator=generator,
                          n_steps=n_steps)
        metrics = batch_audio_metrics(audio[..., 0], rec[..., 0])
        for k, v in metrics.items():
            avgs[k].add(float(v), n=audio.shape[0])
        if save_dir is not None and dumped < max_samples:
            _dump_wavs(save_dir, "audio_gt", dumped,
                       audio[..., 0].cpu().numpy(), sample_rate, max_samples)
            dumped += _dump_wavs(save_dir, "audio_gen", dumped,
                                 rec[..., 0].cpu().numpy(), sample_rate,
                                 max_samples)
    return {f"eval_ae/{k}": a.item() for k, a in avgs.items()}


@torch.no_grad()
def evaluate_audio_zdm(zdm: ZDMNet, ae: DiToAudio,
                       batches: Iterable[np.ndarray],
                       generator: torch.Generator,
                       save_dir: Optional[str] = None,
                       sample_rate: int = 24000,
                       max_samples: int = 1000, ema: bool = True) -> dict:
    """The ZDM eval: one unconditional sample per held-out batch, of its
    size; the average L1 against the batch (a weak distributional proxy,
    kept as the JAX package keeps it), and dumped samples."""
    z_stride = math.prod(ae.cfg.enc_strides)
    dev = module_device(zdm)
    l1 = Averager()
    dumped = 0
    for audio in batches:
        audio = torch.as_tensor(np.asarray(audio), device=dev)
        gen = zdm_generate(zdm, ae, audio.shape[0],
                           audio.shape[1] // z_stride, audio.shape[1],
                           generator=generator)
        l1.add(float(torch.mean(torch.abs(gen - audio))), n=audio.shape[0])
        if save_dir is not None and dumped < max_samples:
            _dump_wavs(save_dir, "audio_gt", dumped,
                       audio[..., 0].cpu().numpy(), sample_rate, max_samples)
            dumped += _dump_wavs(save_dir, "audio_gen", dumped,
                                 gen[..., 0].cpu().numpy(), sample_rate,
                                 max_samples)
    prefix = "eval_zdm_ema" if ema else "eval_zdm"
    return {f"{prefix}/l1_loss_avg": l1.item()}


def save_audio_sample(save_dir: str, name: str, step: int,
                      audio: np.ndarray, sample_rate: int = 24000,
                      spectrogram: bool = True) -> str:
    """A wav (peak-normalised above 1) and, when matplotlib is there, a
    spectrogram figure beside it. audio: (T,) float. Returns the wav's
    path."""
    from minimax_speech_torch.cli.synthesize import write_wav
    d = os.path.join(save_dir, "audio_samples")
    os.makedirs(d, exist_ok=True)
    peak = np.abs(audio).max()
    if peak > 1.0:
        audio = audio / peak
    path = os.path.join(d, f"{name}_step_{step}.wav")
    write_wav(path, audio, sample_rate)
    if spectrogram:
        try:
            import matplotlib
        except ImportError:  # an optional artifact channel
            return path
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        spec = power_spectrogram(torch.as_tensor(np.asarray(
            audio, np.float32))[None], n_fft=2048, hop=512)[0].numpy()
        spec_db = 10.0 * np.log10(spec + 1e-8)
        fig, ax = plt.subplots(figsize=(10, 4))
        im = ax.imshow(spec_db.T, aspect="auto", origin="lower",
                       cmap="viridis",
                       extent=[0, len(audio) / sample_rate,
                               0, sample_rate / 2])
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Frequency (Hz)")
        ax.set_title(f"{name} - Spectrogram")
        fig.colorbar(im, ax=ax, label="dB")
        fig.savefig(path.replace(".wav", "_spec.png"), bbox_inches="tight")
        plt.close(fig)
    return path


@torch.no_grad()
def visualize_audio_ae_random(model: DiToAudio, dataset: np.ndarray,
                              generator: torch.Generator, save_dir: str,
                              step: int, n_samples: int = 8,
                              n_steps: Optional[int] = None,
                              sample_rate: int = 24000):
    """Dump random original/reconstruction pairs of the (N, T, 1) eval
    clips: the choice and the start noise from `generator`."""
    idx = torch.randperm(dataset.shape[0], generator=generator,
                         device=generator.device).cpu().numpy()[:n_samples]
    batch = torch.as_tensor(dataset[idx], device=module_device(model))
    _, mu, _ = model.encode(batch)
    rec = dito_decode(model, mu, batch.shape[1], generator=generator,
                      n_steps=n_steps).cpu().numpy()
    for j, i in enumerate(idx):
        save_audio_sample(save_dir, f"audio_ae_original_{int(i)}", step,
                          dataset[i, :, 0], sample_rate)
        save_audio_sample(save_dir, f"audio_ae_recons_{int(i)}", step,
                          rec[j, :, 0], sample_rate)


def visualize_audio_zdm_random(zdm: ZDMNet, ae: DiToAudio, out_len: int,
                               generator: torch.Generator, save_dir: str,
                               step: int, n_samples: int = 8,
                               sample_rate: int = 24000):
    """Dump unconditional generations."""
    z_stride = math.prod(ae.cfg.enc_strides)
    gen = zdm_generate(zdm, ae, n_samples, out_len // z_stride, out_len,
                       generator=generator).cpu().numpy()
    for i in range(n_samples):
        save_audio_sample(save_dir, f"audio_zdm_generated_{i}", step,
                          gen[i, :, 0], sample_rate)
