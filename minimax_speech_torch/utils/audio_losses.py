"""Spectral reconstruction losses of DAC-VAE and vocoder training.

Port of minimax_speech_tpu/utils/audio_losses.py: the multi-scale STFT
L1 on log and linear magnitudes, the multi-resolution mel L1 (n_mels 5
to 320 over windows of 32 to 2048 samples, hop a quarter window),
waveform L1 and negative SI-SDR, over (B, T) audio.
"""
from __future__ import annotations

from typing import Sequence

import torch

from minimax_speech_torch.ops import mel as mel_ops


def _magnitude(x, n_fft):
    """|STFT| (B, frames, 1 + n_fft//2), centered, hop n_fft // 4."""
    return torch.sqrt(mel_ops.stft_magnitude(x, n_fft, n_fft // 4, n_fft))


def _log_l1(mx, my, clamp_eps, pow):
    return torch.mean(torch.abs(
        torch.log10(torch.clamp(mx, min=clamp_eps) ** pow)
        - torch.log10(torch.clamp(my, min=clamp_eps) ** pow)))


def multi_scale_stft_loss(x: torch.Tensor, y: torch.Tensor,
                          window_lengths: Sequence[int] = (2048, 512),
                          clamp_eps: float = 1e-5, mag_weight: float = 1.0,
                          log_weight: float = 1.0, pow: float = 2.0):
    """L1 on log10(mag^pow) plus L1 on mag, summed over the scales."""
    loss = 0.0
    for w in window_lengths:
        mx, my = _magnitude(x, w), _magnitude(y, w)
        loss = loss + log_weight * _log_l1(mx, my, clamp_eps, pow)
        loss = loss + mag_weight * torch.mean(torch.abs(mx - my))
    return loss


def mel_spectrogram_loss(x: torch.Tensor, y: torch.Tensor,
                         sample_rate: int = 24000,
                         n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160,
                                                  320),
                         window_lengths: Sequence[int] = (32, 64, 128, 256,
                                                          512, 1024, 2048),
                         clamp_eps: float = 1e-5, mag_weight: float = 0.0,
                         log_weight: float = 1.0, pow: float = 1.0):
    """The multi-resolution mel L1: at each (n_mels, window), L1 on
    log10(mel^pow) (plus mag_weight times L1 on the mels)."""
    loss = 0.0
    for nm, w in zip(n_mels, window_lengths):
        filters = torch.as_tensor(mel_ops.mel_filterbank(sample_rate, w, nm),
                                  dtype=x.dtype, device=x.device)
        mx = torch.einsum("mf,btf->btm", filters, _magnitude(x, w))
        my = torch.einsum("mf,btf->btm", filters, _magnitude(y, w))
        loss = loss + log_weight * _log_l1(mx, my, clamp_eps, pow)
        if mag_weight:
            loss = loss + mag_weight * torch.mean(torch.abs(mx - my))
    return loss


def l1_loss(x, y):
    return torch.mean(torch.abs(x - y))


def sisdr_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8):
    """Negative SI-SDR in dB of x against the target y, batch mean."""
    x = x - x.mean(dim=-1, keepdim=True)
    y = y - y.mean(dim=-1, keepdim=True)
    dot = torch.sum(x * y, dim=-1, keepdim=True)
    s_target = dot * y / (torch.sum(y * y, dim=-1, keepdim=True) + eps)
    e_noise = x - s_target
    ratio = (torch.sum(s_target ** 2, -1) + eps) / (
        torch.sum(e_noise ** 2, -1) + eps)
    return -10.0 * torch.mean(torch.log10(ratio))
