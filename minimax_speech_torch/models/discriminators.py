"""GAN discriminators of DAC-VAE and HiFT training.

Port of minimax_speech_tpu/models/discriminators.py:
  * DACDiscriminator: multi-period (MPD, periods 2, 3, 5, 7, 11) and
    complex multi-band spectral (MRDBand, FFTs 2048, 1024, 512)
    discriminators, optionally multi-scale (MSD), after DC removal and
    peak normalization;
  * CosyVoiceDiscriminator: MPD and magnitude-STFT
    (SpecDiscriminator) discriminators.

Each takes (B, T) audio and returns (scores, feature maps), lists over
its sub-discriminators, for the GAN losses of utils/losses.py. Layouts
are torch's, (B, C, H, W) and (B, C, T): an MPD folds time into H and
the period into W, a spectral one puts frames in H and bins in W, where
the JAX package keeps channels last. Submodules carry the flax names,
explicit (mpd_2, band0_conv1, conv_post) or automatic (WNConv2d_0,
Conv_3), so params_io maps the weights across; a WNConv2d keeps v as
(out, in, kh, kw) and the bridge transposes it from flax's (kh, kw, in,
out).

Strided convolutions are plain strided F.conv2d / F.conv1d: a stride-s
convolution with the same padding computes what the JAX package's
stride-1 convolution followed by [::s] (or its ops/safe_conv.py
reformulation, a TPU workaround) does.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.ops import mel as mel_ops

BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
LRELU = 0.1
SPEC_CONVS = (((3, 9), (1, 1)), ((3, 9), (1, 2)), ((3, 9), (1, 2)),
              ((3, 9), (1, 2)), ((3, 3), (1, 1)))


class WNConv2d(nn.Module):
    """Weight-normalized Conv2d: kernel g / sqrt(sum(v^2) + 1e-12) * v, the
    norm per output channel."""
    # torch layout = flax layout (kh, kw, in, out) transposed by this
    flax_perm = {"v": (3, 2, 0, 1)}

    def __init__(self, in_ch: int, features: int, kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.strides, self.padding = tuple(strides), tuple(padding)
        self.v = nn.Parameter(torch.zeros(features, in_ch, *kernel))
        self.g = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_weights(self, generator):
        bound = 1.0 / math.sqrt(self.v[0].numel())
        self.v.data.uniform_(-bound, bound, generator=generator)
        self.g.data.copy_(torch.sqrt(self.v.data.square().sum(dim=(1, 2, 3))
                                     + 1e-12))
        self.bias.data.zero_()

    def forward(self, x):
        norm = torch.sqrt(self.v.square().sum(dim=(1, 2, 3), keepdim=True)
                          + 1e-12)
        w = self.g[:, None, None, None] / norm * self.v
        return F.conv2d(x, w, self.bias, self.strides, self.padding)


def _lrelu(x):
    return F.leaky_relu(x, LRELU)


class _Stack(nn.Module):
    """Convolutions run in order, leaky ReLU after all but the last;
    each registered under flax's automatic name, `prefix`_<index>."""
    prefix = "WNConv2d"

    def __init__(self):
        super().__init__()
        self.convs = []

    def _add(self, conv):
        self.add_module(f"{self.prefix}_{len(self.convs)}", conv)
        self.convs.append(conv)

    def _run(self, h):
        """(last output, feature maps: every output)."""
        fmap = []
        for conv in self.convs[:-1]:
            h = _lrelu(conv(h))
            fmap.append(h)
        h = self.convs[-1](h)
        fmap.append(h)
        return h, fmap


class MPD(_Stack):
    """Multi-period discriminator: audio folded by `period` into (B, 1,
    T / period, period), then (5, 1) convs of stride (3, 1)."""

    def __init__(self, period: int,
                 channels: Sequence[int] = (32, 128, 512, 1024, 1024)):
        super().__init__()
        self.period = period
        ch_in = 1
        for ch, s in zip(channels, [(3, 1)] * 4 + [(1, 1)]):
            self._add(WNConv2d(ch_in, ch, (5, 1), s, (2, 0)))
            ch_in = ch
        self._add(WNConv2d(ch_in, 1, (3, 1), (1, 1), (1, 0)))

    def forward(self, x):
        b, t = x.shape
        pad = (-t) % self.period
        if pad:  # the last `pad` samples, reversed (not a reflect pad)
            x = torch.cat([x, x[:, t - pad:].flip(1)], dim=1)
        h = x.reshape(b, 1, -1, self.period)
        return self._run(h)


class MRDBand(nn.Module):
    """Complex multi-band spectral discriminator at one FFT size: (real,
    imag) of the STFT as (B, 2, frames, bins), cut into bands at int(b *
    bins), a conv stack per band, the bands joined along bins, conv_post."""

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 bands=BANDS, channels: int = 32):
        super().__init__()
        self.window_length = window_length
        self.hop = int(window_length * hop_factor)
        nf = window_length // 2 + 1
        self.bands = [(int(b0 * nf), int(b1 * nf)) for b0, b1 in bands]
        self.band_convs = []
        for bi in range(len(bands)):
            convs, ch_in = [], 2
            for li, (k, s) in enumerate(SPEC_CONVS):
                conv = WNConv2d(ch_in, channels, k, s,
                                ((k[0] - 1) // 2, (k[1] - 1) // 2))
                self.add_module(f"band{bi}_conv{li}", conv)
                convs.append(conv)
                ch_in = channels
            self.band_convs.append(convs)
        self.conv_post = WNConv2d(channels, 1, (3, 3), (1, 1), (1, 1))

    def forward(self, x):
        spec = mel_ops.stft(x, self.window_length, self.hop)
        z = torch.stack([spec.real, spec.imag], dim=1)  # (B, 2, T, F)
        fmap, outs = [], []
        for (lo, hi), convs in zip(self.bands, self.band_convs):
            h = z[..., lo:hi]
            for conv in convs:
                h = _lrelu(conv(h))
                fmap.append(h)
            outs.append(h)
        h = self.conv_post(torch.cat(outs, dim=3))
        fmap.append(h)
        return h, fmap


class MSD(_Stack):
    """Multi-scale waveform discriminator at one rate: average-pooled by
    `rate` (pads counted), then grouped 1-D convs."""
    prefix = "Conv"
    SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
             (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20),
             (1024, 5, 1, 1, 2))

    def __init__(self, rate: int = 1):
        super().__init__()
        self.rate = rate
        ch_in = 1
        for ch, k, s, groups, pad in self.SPECS:
            self._add(nn.Conv1d(ch_in, ch, k, stride=s, padding=pad,
                                groups=min(groups, ch_in)))
            ch_in = ch
        self._add(nn.Conv1d(ch_in, 1, 3, padding=1))

    def forward(self, x):
        h = x[:, None]
        if self.rate > 1:
            h = F.avg_pool1d(h, 2 * self.rate, self.rate, padding=self.rate,
                             count_include_pad=True)
        return self._run(h)


class SpecDiscriminator(_Stack):
    """Magnitude-STFT discriminator: |STFT| (eps 1e-12) as (B, 1, frames,
    bins), a conv stack; the score flattened to (B, frames * bins)."""

    def __init__(self, fft_size: int = 1024, shift_size: int = 120,
                 win_length: int = 600):
        super().__init__()
        self.fft_size, self.shift_size = fft_size, shift_size
        self.win_length = win_length
        ch_in = 1
        for k, s in SPEC_CONVS:
            self._add(WNConv2d(ch_in, 32, k, s,
                               ((k[0] - 1) // 2, (k[1] - 1) // 2)))
            ch_in = 32
        self._add(WNConv2d(32, 1, (3, 3), (1, 1), (1, 1)))

    def forward(self, x):
        h = mel_ops.stft_magnitude(x, self.fft_size, self.shift_size,
                                   self.win_length, center=True, power=1.0,
                                   eps=1e-12)[:, None]
        h, fmap = self._run(h)
        return h.reshape(h.shape[0], -1), fmap


def _preprocess(x):
    """DC removal, then peak normalization to 0.8."""
    x = x - x.mean(dim=-1, keepdim=True)
    return 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)


class _Group(nn.Module):
    """Sub-discriminators in order, each under its flax name."""

    def __init__(self, named):
        super().__init__()
        self.subs = []
        for name, mod in named:
            self.add_module(name, mod)
            self.subs.append(mod)

    def run(self, x):
        scores, fmaps = [], []
        for d in self.subs:
            s, f = d(x)
            scores.append(s)
            fmaps.append(f)
        return scores, fmaps


class DACDiscriminator(_Group):
    """MPD per period, MSD per rate, MRDBand per FFT size, on the
    DC-removed, peak-normalized audio."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 fft_sizes: Tuple[int, ...] = (2048, 1024, 512),
                 rates: Tuple[int, ...] = ()):
        super().__init__([(f"mpd_{p}", MPD(p)) for p in periods]
                         + [(f"msd_{r}", MSD(r)) for r in rates]
                         + [(f"mrd_{w}", MRDBand(w)) for w in fft_sizes])

    def forward(self, x):
        return self.run(_preprocess(x))


class CosyVoiceDiscriminator(_Group):
    """MPD per period, SpecDiscriminator per (FFT, hop, window)."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11),
                 fft_sizes: Tuple[int, ...] = (1024, 2048, 512),
                 hop_sizes: Tuple[int, ...] = (120, 240, 50),
                 win_lengths: Tuple[int, ...] = (600, 1200, 240)):
        super().__init__(
            [(f"mpd_{p}", MPD(p)) for p in periods]
            + [(f"spec_{f}", SpecDiscriminator(f, h, w))
               for f, h, w in zip(fft_sizes, hop_sizes, win_lengths)])

    def forward(self, x):
        return self.run(x)
