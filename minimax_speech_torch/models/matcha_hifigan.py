"""Matcha-TTS vocoder: the HiFi-GAN V1 generator and its spectral
denoiser.

Port of minimax_speech_tpu/models/matcha_hifigan.py: weight-normed convs
(the DAC-VAE's WNConv and WNConvTranspose, their g/v in the JAX
package's layout), transposed-conv upsampling, ResBlock1 leaky-ReLU
residual stacks and a tanh output; and the WaveGlow-style denoiser that
subtracts the vocoder's zero-mel bias spectrum and keeps the noisy
phase, through torch.fft and ops/mel.py's frames, window and istft. The
generator runs channels-first inside; its surface is channel-last (B, T,
80) mels like the JAX package's. matcha_hifigan_params converts a
released `generator_v1` state dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.models.dac_vae import WNConv, WNConvTranspose
from minimax_speech_torch.ops import mel as mel_ops

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class MatchaHiFiGANConfig:
    in_channels: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.upsample_rates))


class MatchaResBlock1(nn.Module):
    """Per dilation d: leaky ReLU -> dilated conv -> leaky ReLU -> conv,
    residual."""

    def __init__(self, channels: int, kernel_size: int, dilations):
        super().__init__()
        k = kernel_size
        self.n = len(dilations)
        for j, d in enumerate(dilations):
            self.add_module(f"conv1_{j}", WNConv(
                channels, channels, k, padding=(k * d - d) // 2, dilation=d))
            self.add_module(f"conv2_{j}", WNConv(
                channels, channels, k, padding=(k - 1) // 2))

    def forward(self, x):  # (B, C, T)
        for j in range(self.n):
            h = getattr(self, f"conv1_{j}")(F.leaky_relu(x, LRELU_SLOPE))
            h = getattr(self, f"conv2_{j}")(F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class MatchaHiFiGAN(nn.Module):
    def __init__(self, cfg: MatchaHiFiGANConfig = MatchaHiFiGANConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.n_k = len(c.resblock_kernel_sizes)
        ch = c.upsample_initial_channel
        self.conv_pre = WNConv(c.in_channels, ch, 7, padding=3)
        for i, (u, k) in enumerate(zip(c.upsample_rates,
                                       c.upsample_kernel_sizes)):
            out = c.upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"ups_{i}", WNConvTranspose(
                ch, out, k, u, padding=(k - u) // 2))
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i * self.n_k + j}",
                                MatchaResBlock1(out, rk, rd))
            ch = out
        self.conv_post = WNConv(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel: (B, T, in_channels) -> (B, T * hop) audio in [-1, 1]."""
        x = self.conv_pre(mel.transpose(1, 2))
        for i in range(len(self.cfg.upsample_rates)):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(self.n_k):
                h = getattr(self, f"resblocks_{i * self.n_k + j}")(x)
                acc = h if acc is None else acc + h
            x = acc / self.n_k
        x = self.conv_post(F.leaky_relu(x))
        return torch.tanh(x)[:, 0]


def matcha_hifigan_params(state: dict,
                          cfg: MatchaHiFiGANConfig = MatchaHiFiGANConfig(),
                          ) -> dict:
    """A Matcha/HiFi-GAN `generator_v1` torch state dict -> the flax
    variables tree MatchaHiFiGAN loads."""
    from minimax_speech_torch.utils.convert import _wn_conv, strip_prefix
    state = strip_prefix(state, ("generator.", "module."))
    p = {"conv_pre": _wn_conv(state, "conv_pre."),
         "conv_post": _wn_conv(state, "conv_post.")}
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        p[f"ups_{i}"] = _wn_conv(state, f"ups.{i}.")
        for j in range(n_k):
            m = i * n_k + j
            rb = {}
            for jj in range(len(cfg.resblock_dilation_sizes[j])):
                rb[f"conv1_{jj}"] = _wn_conv(state,
                                             f"resblocks.{m}.convs1.{jj}.")
                rb[f"conv2_{jj}"] = _wn_conv(state,
                                             f"resblocks.{m}.convs2.{jj}.")
            p[f"resblocks_{m}"] = rb
    return {"params": p}


class Denoiser:
    """The spectral denoiser: subtract `strength` times the vocoder's
    zero-mel (or fixed normal-mel) bias spectrum from an audio's STFT
    magnitude, keep its phase, invert. `vocoder` maps a (1, frames,
    n_mels) mel on `device` to (1, samples) audio."""

    def __init__(self, vocoder: Callable, filter_length: int = 1024,
                 n_overlap: int = 4, mode: str = "zeros",
                 mel_frames: int = 88, n_mels: int = 80, device=None):
        self.n_fft = filter_length
        self.hop = filter_length // n_overlap
        if mode == "zeros":
            mel = np.zeros((1, mel_frames, n_mels), np.float32)
        elif mode == "normal":
            mel = np.random.default_rng(0).standard_normal(
                (1, mel_frames, n_mels)).astype(np.float32)
        else:
            raise ValueError(mode)
        with torch.no_grad():
            audio = vocoder(torch.as_tensor(mel, device=device))[0]
            self.bias_spec = self._stft(audio)[0][:1]  # first frame's mags

    def _stft(self, audio: torch.Tensor):
        p = self.n_fft // 2
        x = F.pad(audio[None], (p, p), mode="reflect")[0]
        frames = mel_ops.frame_signal(x, self.n_fft, self.hop)
        win = mel_ops.hann_window(self.n_fft, x.dtype, x.device)
        spec = torch.fft.rfft(frames * win, n=self.n_fft, dim=-1)
        mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-12)
        return mag, torch.atan2(spec.imag, spec.real)

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor,
                 strength: float = 0.0005) -> torch.Tensor:
        """audio: (T,) -> (T',) denoised."""
        mag, phase = self._stft(audio)
        mag = torch.clamp(mag - self.bias_spec * strength, min=0.0)
        return mel_ops.istft((mag * torch.cos(phase)).T,
                             (mag * torch.sin(phase)).T, self.n_fft,
                             self.hop)
