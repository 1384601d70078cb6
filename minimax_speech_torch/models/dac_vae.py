"""DAC-VAE continuous audio codec: encoder (z, mu, logs) and decoder.

Port of minimax_speech_tpu/models/dac_vae.py: inference, the training
forward (the reparameterized latent z = mu + eps exp(logs)) and the
converter of an upstream state dict. Snake
activations and weight-normalized convs, with the weight norm kept as
explicit (g, v) parameters in the JAX layout: the kernel is
g / sqrt(sum(v^2) + 1e-12) * v. Strided and transposed convs are plain
conv1d / conv_transpose1d (the JAX package's safe_conv reformulation
exists for a TPU backend fault and computes the same function).
Internally channels-first (B, C, T); the public encode/decode keep the
JAX package's channel-last layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class DACVAEConfig:
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 3, 4, 4, 5)
    latent_dim: int = 80
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (5, 4, 4, 3, 2)
    d_in: int = 1
    d_out: int = 1
    sample_rate: int = 24000
    use_tanh_final: bool = True

    def __post_init__(self):
        if self.decoder_dim // 2 ** len(self.decoder_rates) < 1:
            raise ValueError(
                f"decoder_dim={self.decoder_dim} too small: it halves per "
                f"decoder block and must stay >= 1 after "
                f"{len(self.decoder_rates)} blocks")

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))


# per-conv init variance multiplier (fan_in * Var(w)) of the JAX package
INIT_VAR = 0.5


class Snake1d(nn.Module):
    """x + (1 / (a + 1e-9)) sin^2(a x), per-channel a stored (1, 1, C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, 1, channels))

    def init_weights(self, generator):
        self.alpha.data.fill_(1.0)

    def forward(self, x):  # (B, C, T)
        a = self.alpha.view(1, -1, 1)
        return x + (1.0 / (a + 1e-9)) * torch.sin(a * x).square()


def _wn_kernel(g, v):
    """g / ||v|| * v with the norm over the first two (flax) axes."""
    norm = torch.sqrt(v.square().sum(dim=(0, 1), keepdim=True) + 1e-12)
    return (g[None, None, :] / norm) * v


class _WN(nn.Module):
    """Shared (g, v, bias) storage and init of the weight-normed convs."""

    def __init__(self, v_shape, g_dim: int, out: int, fan_in: int,
                 init_var: float, bias_init=None):
        super().__init__()
        self.fan_in = fan_in
        self.init_var = init_var
        self.bias_init = bias_init  # the bias at init (default 0)
        self.v = nn.Parameter(torch.zeros(v_shape))
        self.g = nn.Parameter(torch.ones(g_dim))
        self.bias = nn.Parameter(torch.zeros(out))

    def init_weights(self, generator):
        bound = math.sqrt(3.0 * self.init_var / self.fan_in)
        self.v.data.uniform_(-bound, bound, generator=generator)
        self.g.data.copy_(torch.sqrt(self.v.data.square().sum(dim=(0, 1))
                                     + 1e-12))
        self.bias.data.zero_()
        if self.bias_init is not None:
            self.bias.data.copy_(torch.as_tensor(self.bias_init))


class WNConv(_WN):
    """Weight-normalized Conv1d; v is (k, in, out), the norm per output
    channel."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias_init=None):
        super().__init__((kernel_size, in_ch, features), features, features,
                         kernel_size * in_ch, INIT_VAR, bias_init)
        self.stride, self.padding, self.dilation = stride, padding, dilation

    def forward(self, x):  # (B, C, T)
        w = _wn_kernel(self.g, self.v).permute(2, 1, 0)  # (out, in, k)
        return F.conv1d(x, w, self.bias, self.stride, self.padding,
                        self.dilation)


class WNConvTranspose(_WN):
    """Weight-normalized ConvTranspose1d; v is (k, out, in), the norm per
    input channel; out length (T-1)*s - 2*pad + k + output_padding."""

    def __init__(self, in_ch: int, features: int, kernel_size: int,
                 stride: int, padding: int, output_padding: int = 0):
        super().__init__((kernel_size, features, in_ch), in_ch, features,
                         kernel_size * in_ch, INIT_VAR * stride)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding

    def forward(self, x):  # (B, C, T)
        w = _wn_kernel(self.g, self.v).permute(2, 1, 0)  # (in, out, k)
        return F.conv_transpose1d(x, w, self.bias, self.stride, self.padding,
                                  self.output_padding)


class ResidualUnit(nn.Module):
    """Snake -> dilated WNConv (k 7) -> Snake -> WNConv (k 1), residual."""

    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        self.snake1 = Snake1d(dim)
        self.conv1 = WNConv(dim, dim, 7, padding=(6 * dilation) // 2,
                            dilation=dilation)
        self.snake2 = Snake1d(dim)
        self.conv2 = WNConv(dim, dim, 1)

    def forward(self, x):
        y = self.conv2(self.snake2(self.conv1(self.snake1(x))))
        crop = (x.shape[-1] - y.shape[-1]) // 2
        if crop > 0:
            x = x[..., crop:-crop]
        return x + y


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.res1 = ResidualUnit(dim // 2, 1)
        self.res2 = ResidualUnit(dim // 2, 3)
        self.res3 = ResidualUnit(dim // 2, 9)
        self.snake = Snake1d(dim // 2)
        self.down = WNConv(dim // 2, dim, 2 * stride, stride=stride,
                           padding=math.ceil(stride / 2))

    def forward(self, x):
        return self.down(self.snake(self.res3(self.res2(self.res1(x)))))


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int):
        super().__init__()
        self.snake = Snake1d(input_dim)
        self.up = WNConvTranspose(input_dim, output_dim, 2 * stride, stride,
                                  padding=math.ceil(stride / 2),
                                  output_padding=stride % 2)
        self.res1 = ResidualUnit(output_dim, 1)
        self.res2 = ResidualUnit(output_dim, 3)
        self.res3 = ResidualUnit(output_dim, 9)

    def forward(self, x):
        return self.res3(self.res2(self.res1(self.up(self.snake(x)))))


class DACEncoder(nn.Module):
    def __init__(self, cfg: DACVAEConfig):
        super().__init__()
        d = cfg.encoder_dim
        self.conv_in = WNConv(cfg.d_in, d, 7, padding=3)
        self.blocks = []
        for i, s in enumerate(cfg.encoder_rates):
            d *= 2
            blk = EncoderBlock(d, s)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.snake_out = Snake1d(d)
        self.conv_out = WNConv(d, cfg.latent_dim, 3, padding=1)

    def forward(self, audio):  # (B, d_in, T) -> (B, latent, T / hop)
        h = self.conv_in(audio)
        for blk in self.blocks:
            h = blk(h)
        return self.conv_out(self.snake_out(h))


class DACDecoder(nn.Module):
    def __init__(self, cfg: DACVAEConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.decoder_dim
        self.conv_in = WNConv(cfg.latent_dim, dim, 7, padding=3)
        self.blocks = []
        for i, s in enumerate(cfg.decoder_rates):
            blk = DecoderBlock(dim, dim // 2, s)
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
            dim //= 2
        self.snake_out = Snake1d(dim)
        self.conv_out = WNConv(dim, cfg.d_out, 7, padding=3)

    def forward(self, z):  # (B, latent, T) -> (B, d_out, T * hop)
        h = self.conv_in(z)
        for blk in self.blocks:
            h = blk(h)
        h = self.conv_out(self.snake_out(h))
        return torch.tanh(h) if self.cfg.use_tanh_final else h.clamp(-1, 1)


class DACVAE(nn.Module):
    def __init__(self, cfg: DACVAEConfig = DACVAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = DACEncoder(cfg)
        self.decoder = DACDecoder(cfg)
        # at init mu's bias is 0 and logs' is -4 (sigma ~ 0.018), so that
        # the reparameterization noise cannot swamp the encoder's signal
        # (the posterior collapse of a from-scratch run at sigma 1); the
        # annealed KL raises sigma as training goes on
        lat = cfg.latent_dim
        self.en_conv_post = WNConv(lat, 2 * lat, 1,
                                   bias_init=[0.0] * lat + [-4.0] * lat)
        self.de_conv_pre = WNConv(lat, lat, 1)

    def encode(self, audio, generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None):
        """audio: (B, T, d_in), T a multiple of hop_length -> (z, mu, logs),
        each (B, T / hop, latent), logs clipped to +-14 and z = mu + eps
        exp(logs): eps as given, else drawn from `generator` (standard
        normal), else z is mu."""
        x = self.encoder(audio.transpose(1, 2))
        x = self.en_conv_post(F.leaky_relu(x, negative_slope=0.01))
        mu, logs = x.transpose(1, 2).chunk(2, dim=-1)
        logs = torch.clamp(logs, -14.0, 14.0)
        if eps is None and generator is not None:
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                              device=mu.device)
        z = mu if eps is None else mu + eps * torch.exp(logs)
        return z, mu, logs

    def decode(self, z):
        """z: (B, T, latent) -> audio (B, T * hop, d_out)."""
        return self.decoder(self.de_conv_pre(z.transpose(1, 2))).transpose(
            1, 2)

    def forward(self, audio, generator: torch.Generator | None = None,
                eps: torch.Tensor | None = None) -> dict:
        """The training forward: {"audio": decode(z), "z", "mu", "logs"},
        the draws as encode takes them."""
        z, mu, logs = self.encode(audio, generator, eps)
        return {"audio": self.decode(z), "z": z, "mu": mu, "logs": logs}


def pad_to_hop(audio: np.ndarray, hop: int) -> np.ndarray:
    """Right-pad (..., T) with zeros to a hop multiple."""
    pad = (-audio.shape[-1]) % hop
    if pad:
        audio = np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])
    return audio


def params_from_torch_state(state: dict, cfg: DACVAEConfig) -> dict:
    """An upstream DACVAE state dict (numpy arrays) with weight-norm
    parameters (*.weight_g / *.weight_v, or
    parametrizations.weight.original0/1) -> the flax variables {"params":
    ...} that params_io loads, as the JAX package's params_from_torch_state
    maps them: v (out, in, k) or, transposed, (in, out, k) becomes (k, in,
    out) or (k, out, in), g flat, Snake alpha (1, C, 1) becomes (1, 1, C)."""
    def norm_key(k):
        return (k.replace("parametrizations.weight.original0", "weight_g")
                 .replace("parametrizations.weight.original1", "weight_v"))

    state = {norm_key(k): v for k, v in state.items()}

    def conv(prefix):
        return {"g": state[prefix + ".weight_g"].reshape(-1),
                "v": np.transpose(state[prefix + ".weight_v"], (2, 1, 0)),
                "bias": state[prefix + ".bias"]}

    def snake(prefix):
        return {"alpha": np.transpose(state[prefix + ".alpha"], (0, 2, 1))}

    def res_units(tp, first, blk):
        # block.{first + j}: Sequential(snake, conv7, snake, conv1)
        for j in range(3):
            u = f"{tp}.block.{first + j}"
            blk[f"res{j + 1}"] = {
                "snake1": snake(f"{u}.block.0"), "conv1": conv(f"{u}.block.1"),
                "snake2": snake(f"{u}.block.2"), "conv2": conv(f"{u}.block.3")}
        return blk

    enc: dict = {"conv_in": conv("encoder.block.0")}
    for i in range(len(cfg.encoder_rates)):
        tp = f"encoder.block.{i + 1}"
        enc[f"block_{i}"] = res_units(tp, 0, {
            "snake": snake(f"{tp}.block.3"), "down": conv(f"{tp}.block.4")})
    n = len(cfg.encoder_rates) + 1
    enc["snake_out"] = snake(f"encoder.block.{n}")
    enc["conv_out"] = conv(f"encoder.block.{n + 1}")

    dec: dict = {"conv_in": conv("decoder.model.0")}
    for i in range(len(cfg.decoder_rates)):
        tp = f"decoder.model.{i + 1}"
        dec[f"block_{i}"] = res_units(tp, 2, {
            "snake": snake(f"{tp}.block.0"), "up": conv(f"{tp}.block.1")})
    n = len(cfg.decoder_rates) + 1
    dec["snake_out"] = snake(f"decoder.model.{n}")
    dec["conv_out"] = conv(f"decoder.model.{n + 1}")
    return {"params": {"encoder": enc, "decoder": dec,
                       "en_conv_post": conv("en_conv_post"),
                       "de_conv_pre": conv("de_conv_pre")}}
