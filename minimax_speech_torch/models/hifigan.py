"""HiFT vocoder: Neural Source Filter + iSTFTNet, 80-bin mel at 50 Hz ->
24 kHz waveform (the mel output mode).

Port of minimax_speech_tpu/models/hifigan.py. Internally channels-first
(B, C, T); the public functions keep the JAX package's layout: mel
(B, T, 80), source (B, T * total_upsample, 1), waveform (B, T *
total_upsample). Submodules carry the flax names (conv_pre, ups_{i},
source_downs_{i}, source_resblocks_{i}, resblocks_{i}, conv_post,
source_linear, f0_predictor/conv_{i} and classifier; act1_{i}, conv1_{i},
act2_{i}, conv2_{i} in a ResBlock), so utils/params_io.py bridges the
weights. The strided source downsamplers are plain Conv1d (the JAX
package's safe_conv.SlicedConv works around a TPU backend fault and
computes the same convolution).

The sine source is deterministic without a generator (zero phases, no
noise: an unvoiced sample is exactly 0), as the JAX package's key=None,
which every synthesis path uses.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.models.dac_vae import (Snake1d, WNConv,
                                                 WNConvTranspose)
from minimax_speech_torch.ops import mel as mel_ops


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates)) * self.istft_hop


class ResBlock(nn.Module):
    """Snake -> dilated WNConv -> Snake -> WNConv, residual, per dilation."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        k = kernel_size
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.add_module(f"act1_{i}", Snake1d(channels))
            self.add_module(f"conv1_{i}", WNConv(
                channels, channels, k, padding=(k * d - d) // 2, dilation=d))
            self.add_module(f"act2_{i}", Snake1d(channels))
            self.add_module(f"conv2_{i}", WNConv(channels, channels, k,
                                                 padding=(k - 1) // 2))

    def forward(self, x):  # (B, C, T)
        m = self._modules
        for i in range(self.n):
            h = m[f"conv1_{i}"](m[f"act1_{i}"](x))
            x = x + m[f"conv2_{i}"](m[f"act2_{i}"](h))
        return x


class ConvRNNF0Predictor(nn.Module):
    """mel (B, C, T) -> f0 in Hz per frame (B, T): 5 WNConv + ELU, a
    Dense, |.|."""

    def __init__(self, in_channels: int, cond_channels: int = 512):
        super().__init__()
        self.convs = []
        for i in range(5):
            conv = WNConv(in_channels if i == 0 else cond_channels,
                          cond_channels, 3, padding=1)
            self.add_module(f"conv_{i}", conv)
            self.convs.append(conv)
        self.classifier = nn.Linear(cond_channels, 1)

    def forward(self, mel):
        h = mel
        for conv in self.convs:
            h = F.elu(conv(h))
        return self.classifier(h.transpose(1, 2))[..., 0].abs()


def harmonic_phase(f0_up: torch.Tensor, cfg: HiFTConfig) -> torch.Tensor:
    """f0_up (B, T) -> theta (B, T, nb_harmonics + 1), each harmonic's
    phase in radians: 2 pi times the cumulative sum of f h / sr, mod 1.
    The cumsum and the mod run in float64 on every device, then theta
    takes f0_up's dtype. A float32 cumsum of 5 s (120000 increments, up
    to 13500 cycles) lay up to half a cycle from float64 on an H100
    (torch's CUDA scan along a non-last dim sums each column in turn in
    float32), where the JAX package's float32 scan on the CPU lies
    within 2 ulp of the cycles summed."""
    harmonics = torch.arange(1, cfg.nb_harmonics + 2, dtype=torch.float64,
                             device=f0_up.device)
    rad = f0_up.double()[:, :, None] * harmonics / cfg.sampling_rate
    cycles = torch.remainder(torch.cumsum(rad, dim=1), 1.0)
    return (2.0 * math.pi * cycles).to(f0_up.dtype)


def sine_source(f0_up: torch.Tensor, cfg: HiFTConfig,
                generator: Optional[torch.Generator] = None,
                phase: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f0_up (B, T) upsampled f0 -> (B, T, nb_harmonics + 1) harmonic
    source before the merge, from harmonic_phase's theta: voiced samples
    (f0 > nsf_voiced_threshold) carry alpha sin(theta + phase) plus sigma
    noise, unvoiced ones alpha/3 noise. The random starting phases (B, 1,
    H) (the fundamental's at 0) and the noise (B, T, H) are `phase` and
    `noise` where given, else drawn from `generator` (uniform in [-pi,
    pi), standard normal), else 0."""
    b, h = f0_up.shape[0], cfg.nb_harmonics + 1
    theta = harmonic_phase(f0_up, cfg)
    if phase is None:
        phase = torch.zeros((b, 1, h), dtype=f0_up.dtype,
                            device=f0_up.device)
        if generator is not None:
            phase = (torch.rand((b, 1, h), generator=generator,
                                dtype=f0_up.dtype, device=f0_up.device)
                     * 2.0 - 1.0) * math.pi
            phase[:, :, 0] = 0.0
    if noise is None:
        noise = torch.zeros_like(theta) if generator is None else \
            torch.randn(theta.shape, generator=generator, dtype=theta.dtype,
                        device=theta.device)
    sine = cfg.nsf_alpha * torch.sin(theta + phase)
    uv = (f0_up > cfg.nsf_voiced_threshold).to(f0_up.dtype)[:, :, None]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    return sine * uv + noise_amp * noise


class HiFTGenerator(nn.Module):
    def __init__(self, cfg: HiFTConfig = HiFTConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.f0_predictor = ConvRNNF0Predictor(c.in_channels,
                                               c.f0_cond_channels)
        self.source_linear = nn.Linear(c.nb_harmonics + 1, 1)
        self.conv_pre = WNConv(c.in_channels, c.base_channels, 7, padding=3)
        nfft2 = c.istft_n_fft + 2
        # the source's downsampling: rates [1] + reversed(up)[:-1],
        # cumulative product, reversed
        down_rates = np.cumprod(
            [1] + list(c.upsample_rates[::-1][:-1]))[::-1]
        self.ups, self.source_downs, self.source_resblocks = [], [], []
        self.resblocks = []
        for i, (u, k) in enumerate(zip(c.upsample_rates,
                                       c.upsample_kernel_sizes)):
            ch_in, ch = c.base_channels // 2 ** i, c.base_channels // 2 ** (
                i + 1)
            self._add(self.ups, f"ups_{i}", WNConvTranspose(
                ch_in, ch, k, u, padding=(k - u) // 2))
            d = int(down_rates[i])
            self._add(self.source_downs, f"source_downs_{i}",
                      nn.Conv1d(nfft2, ch, 1) if d == 1 else nn.Conv1d(
                          nfft2, ch, 2 * d, stride=d, padding=d // 2))
            self._add(self.source_resblocks, f"source_resblocks_{i}",
                      ResBlock(ch, c.source_resblock_kernel_sizes[i],
                               tuple(c.source_resblock_dilations[i])))
        for i in range(len(c.upsample_rates)):
            ch = c.base_channels // 2 ** (i + 1)
            for k, d in zip(c.resblock_kernel_sizes, c.resblock_dilations):
                self._add(self.resblocks, f"resblocks_{len(self.resblocks)}",
                          ResBlock(ch, k, tuple(d)))
        self.conv_post = WNConv(
            c.base_channels // 2 ** len(c.upsample_rates), nfft2, 7,
            padding=3)

    def _add(self, group: list, name: str, module: nn.Module):
        self.add_module(name, module)
        group.append(module)

    def predict_f0(self, mel):
        """mel (B, T, 80) -> f0 (B, T)."""
        return self.f0_predictor(mel.transpose(1, 2))

    def build_source(self, f0, generator=None, phase=None, noise=None):
        """f0 (B, T) at the frame rate -> source (B, T * total_upsample, 1);
        the draws as sine_source."""
        f0_up = torch.repeat_interleave(f0, self.cfg.total_upsample, dim=-1)
        sines = sine_source(f0_up, self.cfg, generator, phase, noise)
        return torch.tanh(self.source_linear(sines))

    def _stft(self, x):
        """(B, T) -> real, imag (B, frames, n_fft//2 + 1): centered, a
        periodic Hann window every hop."""
        spec = mel_ops.stft(x, self.cfg.istft_n_fft, self.cfg.istft_hop)
        return spec.real, spec.imag

    def decode(self, mel, source):
        """mel (B, T, 80), source (B, T * total_upsample, 1) -> waveform
        (B, T * total_upsample) in [-audio_limit, audio_limit]."""
        c = self.cfg
        s_real, s_imag = self._stft(source[..., 0])
        s_stft = torch.cat([s_real, s_imag], dim=-1).transpose(1, 2)
        x = self.conv_pre(mel.transpose(1, 2))
        n_k = len(c.resblock_kernel_sizes)
        n_up = len(c.upsample_rates)
        for i in range(n_up):
            x = self.ups[i](F.leaky_relu(x, c.lrelu_slope))
            if i == n_up - 1:  # reflection pad (1, 0) in time
                x = torch.cat([x[:, :, 1:2], x], dim=2)
            x = x + self.source_resblocks[i](self.source_downs[i](s_stft))
            acc = self.resblocks[i * n_k](x)
            for j in range(1, n_k):
                acc = acc + self.resblocks[i * n_k + j](x)
            x = acc / n_k
        # flax's leaky_relu default slope, not lrelu_slope
        x = self.conv_post(F.leaky_relu(x, 0.01))
        nf = c.istft_n_fft // 2 + 1
        magnitude = torch.exp(torch.clamp(x[:, :nf], max=math.log(1e2)))
        phase = torch.sin(x[:, nf:])
        wav = mel_ops.istft(magnitude * torch.cos(phase),
                            magnitude * torch.sin(phase), c.istft_n_fft,
                            c.istft_hop)
        return torch.clamp(wav, -c.audio_limit, c.audio_limit)

    def forward(self, mel, generator: Optional[torch.Generator] = None,
                cache_source: Optional[torch.Tensor] = None):
        """mel (B, T, 80) -> (waveform (B, T * total_upsample), source).

        cache_source: (B, S, 1) source of the previous streaming hop; its S
        samples replace the new source's first S, so that the harmonics'
        phases run on across hops."""
        s = self.build_source(self.predict_f0(mel), generator)
        if cache_source is not None and cache_source.shape[1] > 0:
            n = cache_source.shape[1]
            s = torch.cat([cache_source.to(s.dtype), s[:, n:]], dim=1)
        return self.decode(mel, s), s
