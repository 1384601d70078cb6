"""Codec and vocoder GAN training on the card against the CPU. This file
imports no JAX, so that `python -m pytest -m cuda
tests/test_torch_gan_card.py` runs on a machine that has the card and
not the JAX package; without a card it skips.

One DAC-VAE and one HiFT iteration (the discriminator's step, then the
generator's) at chip_smoke.py's reduced widths, the same weights, batch
and draws on both devices (phase 37, chip_smoke.gan_cross_check): in
float64 the metrics within 1e-4 relative, every leaf's gradient within
1e-4 of its largest element and the parameters after the step as
chip_smoke.compare_training holds them; in float32 (TF32 off) the
metrics within 1e-4, the gradients printed (the discriminators' leaky
ReLUs make float32 gradients jump: tests/test_torch_gan.py). K1 and K2
are never launched.
"""
import pytest
import torch

import chip_smoke
from minimax_speech_torch.infer.pipeline import TTSConfig


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dac", "hift"])
def test_gan_iteration_card_matches_cpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chip_smoke.tf32_off()
    cfg = TTSConfig().dac if kind == "dac" else TTSConfig().hift
    chip_smoke.gan_cross_check(kind, cfg, device="cuda")
    seen = chip_smoke.read_counts()
    assert seen[1] == 0 and not any(seen[0].values())
