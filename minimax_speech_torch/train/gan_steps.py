"""GAN training steps of the DAC-VAE codec and the HiFT vocoder, and the
DPO step of the Stage-1 LM.

Port of minimax_speech_tpu/train/gan_steps.py.

DAC-VAE (make_dac_steps): the generator's loss is the lambda-weighted
sum of the multi-resolution mel L1, the multi-scale STFT loss and the
waveform L1 (the spectral terms held at exactly 0 for
spectral_delay_steps, then ramped over spectral_warmup_steps), the KL
with beta annealed by the generator's step count, and, from
gan_start_step on, the adversarial and feature-matching losses against
the DACDiscriminator; the discriminator's is LSGAN. HiFT
(make_hift_steps): adversarial + 2x feature matching + 45x mel L1 (the
differentiable hifigan_log_mel) + TPR, plus the f0 L1 when the batch
has pitch; the discriminator's is LSGAN + TPR.

make_dac_steps and make_hift_steps return (gen_step, disc_step); an
iteration runs the discriminator's step, then the generator's, both on
the same batch and the same draws (the DAC's reparameterization noise
eps, HiFT's source phases and noise), so both see the same fake. A step
updates its state in place through steps.backward_and_update (the port's
AdamW and clip); the fake of the discriminator's step and every
real-audio forward run without grad, as no gradient the JAX steps take
reaches them. These steps run on one process, as the JAX CLIs run them.

DPO (make_dpo_step) runs four LM forwards, chosen and rejected plans
through the policy and through a frozen reference policy (a second
SpeechLM, without grad), and one backward, through the port's optimizer
as the LM step does (steps.backward_and_update). The JAX step has no
bf16 route, nor does this one.

Under a mesh the reference policy is sharded as the policy is: the caller
puts it on its tensor-parallel slices (parallel.layers.shard_module with
the "lm" rules), so each rank holds a tp share of it. The loss and the
metrics are this rank's shares of the global batch's pairs, as the LM
step's (utils/losses.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from minimax_speech_torch.ops import mel as mel_ops
from minimax_speech_torch.train import steps
from minimax_speech_torch.train.schedule import global_norm
from minimax_speech_torch.utils import audio_losses, losses
from minimax_speech_torch.utils.device import check_on, resolve_device
from minimax_speech_torch.utils.params_io import named_flax_params


@dataclass(frozen=True)
class DACLambdas:
    """Loss weights of the DAC-VAE generator."""
    mel: float = 15.0
    adv_feat: float = 2.0
    adv_gen: float = 1.0
    kl: float = 0.1
    stft: float = 0.0
    waveform: float = 0.0


def kl_beta(step: int, warmup: int = 10000, beta: float = 1.0) -> float:
    """The KL weight's linear annealing over `warmup` generator steps."""
    return min(step / warmup, 1.0) * beta


def spectral_ramp(step: int, delay: int, warmup: int) -> float:
    """The spectral terms' weight factor: exactly 0 for `delay` steps,
    then linear to 1 over `warmup` (1 when neither is set).

    Without the delay, the log-magnitude terms, whose gradient goes as
    1/|S|, explode while the decoder's output is near silence and, after
    the clip, drown the waveform L1's alignment signal: training settles
    in an energy-matched, uncorrelated output (the JAX package's
    measurement; a ramp alone lands there too)."""
    if delay <= 0 and warmup <= 0:
        return 1.0
    return min(max((step - delay) / max(warmup, 1), 0.0), 1.0)


def _check(device, *mods):
    dev = resolve_device(device)
    for what, mod in mods:
        check_on(mod, dev, what)


def dac_eps(cfg, batch: int, n_samples: int,
            generator: torch.Generator) -> torch.Tensor:
    """The reparameterization noise of a DAC batch of (batch, n_samples)
    audio: standard normal (batch, n_samples / hop, latent), on the
    generator's device."""
    return torch.randn((batch, n_samples // cfg.hop_length, cfg.latent_dim),
                       generator=generator, device=generator.device)


def make_dac_steps(generator, discriminator,
                   lambdas: DACLambdas = DACLambdas(),
                   sample_rate: int = 24000, gan_start_step: int = 0,
                   spectral_warmup_steps: int = 0,
                   spectral_delay_steps: int = 0, device=None):
    """Returns (gen_step, disc_step) for the DACVAE `generator` and its
    `discriminator`, each step(state, batch, eps) -> (state, metrics):
    batch {"audio": (B, T)}, eps the reparameterization noise (dac_eps).
    disc_step's metrics: disc/loss, disc/grad_norm; gen_step's:
    gen/{loss, grad_norm, mel, kl, adv, feat} and
    gen/grad_norm/{encoder_norm, decoder_norm}, the norms before the
    clip. Both modules must live on `device` (default cuda, which raises
    without a GPU)."""
    _check(device, ("the generator", generator),
           ("the discriminator", discriminator))
    names = [path for path, _ in named_flax_params(generator)]

    def disc_step(d_state: steps.TrainState, batch, eps):
        audio = batch["audio"]
        with torch.no_grad():
            fake = generator(audio[..., None], eps=eps)["audio"][..., 0]
        real_scores, _ = discriminator(audio)
        fake_scores, _ = discriminator(fake)
        loss = losses.discriminator_loss(real_scores, fake_scores)
        grads = steps.backward_and_update(d_state, loss)
        return d_state, {"disc/loss": loss.detach(),
                         "disc/grad_norm": global_norm(grads)}

    def gen_step(g_state: steps.TrainState, batch, eps):
        audio = batch["audio"]
        out = generator(audio[..., None], eps=eps)
        fake = out["audio"][..., 0]
        zero = fake.new_zeros(())
        mel = audio_losses.mel_spectrogram_loss(fake, audio, sample_rate) \
            if lambdas.mel else zero
        stft = audio_losses.multi_scale_stft_loss(fake, audio) \
            if lambdas.stft else zero
        wav = audio_losses.l1_loss(fake, audio) if lambdas.waveform else zero
        kl = losses.kl_loss(out["mu"], out["logs"])
        step = g_state.step
        ramp = spectral_ramp(step, spectral_delay_steps,
                             spectral_warmup_steps)
        use_gan = float(step >= gan_start_step)
        fake_scores, fake_fmaps = discriminator(fake)
        with torch.no_grad():
            _, real_fmaps = discriminator(audio)
        adv = losses.generator_adv_loss(fake_scores)
        feat = losses.feature_matching_loss(real_fmaps, fake_fmaps)
        total = (ramp * (lambdas.mel * mel + lambdas.stft * stft)
                 + lambdas.waveform * wav + lambdas.kl * kl_beta(step) * kl
                 + use_gan * (lambdas.adv_gen * adv
                              + lambdas.adv_feat * feat))
        grads = steps.backward_and_update(g_state, total)
        metrics = {"gen/loss": total.detach(),
                   "gen/grad_norm": global_norm(grads),
                   "gen/mel": mel.detach(), "gen/kl": kl.detach(),
                   "gen/adv": adv.detach(), "gen/feat": feat.detach()}
        metrics.update({f"gen/{k}": v for k, v in
                        steps.grad_norms_by_component(
                            list(zip(names, grads)),
                            {"encoder_norm": "encoder",
                             "decoder_norm": "decoder"}).items()})
        return g_state, metrics

    return gen_step, disc_step


@dataclass
class HiFTDraws:
    """The random numbers of HiFT's sine source for one batch: starting
    phases (B, 1, H) (the fundamental's 0) and noise (B, T_samples, H),
    H = nb_harmonics + 1."""
    phase: torch.Tensor
    noise: torch.Tensor


def make_hift_draws(cfg, batch: int, t_mel: int,
                    generator: torch.Generator) -> HiFTDraws:
    """HiFTDraws for a batch of t_mel mel frames: phases uniform in
    [-pi, pi), noise standard normal, on the generator's device."""
    h = cfg.nb_harmonics + 1
    dev = generator.device
    phase = (torch.rand((batch, 1, h), generator=generator, device=dev)
             * 2.0 - 1.0) * math.pi
    phase[:, :, 0] = 0.0
    noise = torch.randn((batch, t_mel * cfg.total_upsample, h),
                        generator=generator, device=dev)
    return HiFTDraws(phase, noise)


def _hift_fake(generator, mel, draws: HiFTDraws):
    """HiFT's waveform (B, T_samples) of mel (B, T, 80) on the draws."""
    source = generator.build_source(generator.predict_f0(mel),
                                    phase=draws.phase, noise=draws.noise)
    return generator.decode(mel, source)


def make_hift_steps(generator, discriminator, mel_weight: float = 45.0,
                    feat_weight: float = 2.0, tpr_weight: float = 1.0,
                    tpr_tau: float = 0.04, device=None):
    """Returns (gen_step, disc_step) for the HiFTGenerator `generator` and
    its `discriminator`, each step(state, batch, draws) -> (state,
    metrics): batch {"speech_feat": (B, T, 80), "audio": (B, T * 480)}
    and optionally "pitch" (B, T), draws a HiFTDraws. disc_step's metric:
    disc/loss; gen_step's: gen/{loss, adv, feat, mel, tpr} and gen/f0
    with pitch. The generator's turn takes TPR with its arguments
    swapped, tpr_loss(fake, real). Both modules must live on `device`
    (default cuda, which raises without a GPU)."""
    _check(device, ("the generator", generator),
           ("the discriminator", discriminator))

    def disc_step(d_state: steps.TrainState, batch, draws: HiFTDraws):
        with torch.no_grad():
            fake = _hift_fake(generator, batch["speech_feat"], draws)
        real_s, _ = discriminator(batch["audio"])
        fake_s, _ = discriminator(fake)
        loss = (losses.discriminator_loss(real_s, fake_s)
                + tpr_weight * losses.tpr_loss(real_s, fake_s, tpr_tau))
        steps.backward_and_update(d_state, loss)
        return d_state, {"disc/loss": loss.detach()}

    def gen_step(g_state: steps.TrainState, batch, draws: HiFTDraws):
        audio = batch["audio"]
        fake = _hift_fake(generator, batch["speech_feat"], draws)
        fake_s, fake_f = discriminator(fake)
        n = min(fake.shape[-1], audio.shape[-1])
        with torch.no_grad():
            real_s, real_f = discriminator(audio)
            real_mel = mel_ops.hifigan_log_mel(audio[..., :n])
        adv = losses.generator_adv_loss(fake_s)
        feat = losses.feature_matching_loss(real_f, fake_f)
        mel_l = audio_losses.l1_loss(mel_ops.hifigan_log_mel(fake[..., :n]),
                                     real_mel)
        tpr = losses.tpr_loss(fake_s, real_s, tpr_tau)
        total = adv + feat_weight * feat + mel_weight * mel_l \
            + tpr_weight * tpr
        metrics = {"gen/adv": adv, "gen/feat": feat, "gen/mel": mel_l,
                   "gen/tpr": tpr}
        if "pitch" in batch:
            f0 = generator.predict_f0(batch["speech_feat"])
            metrics["gen/f0"] = audio_losses.l1_loss(f0, batch["pitch"])
            total = total + metrics["gen/f0"]
        steps.backward_and_update(g_state, total)
        return g_state, {"gen/loss": total.detach(),
                         **{k: v.detach() for k, v in metrics.items()}}

    return gen_step, disc_step

PLAN_KEYS = ("src_type", "tok_id", "target", "seq_len")
REJ = "_rej"  # suffix of the rejected plans' keys in a DPO batch


def _speaker(model, batch: dict):
    """The batch's spk_emb, else its reference mels through `model`'s
    speaker encoder (trained jointly in the policy)."""
    if "spk_emb" in batch:
        return batch["spk_emb"]
    return steps.speaker_of(model, batch)


def _seq_logps(model, batch: dict):
    """(chosen, rejected) summed target log-probs (B,) under `model`."""
    spk = _speaker(model, batch)
    return tuple(model.sequence_logp(*(batch[k + sfx] for k in PLAN_KEYS),
                                     spk) for sfx in ("", REJ))


def make_dpo_step(model, ref_model, beta: float = 0.01,
                  label_smoothing: float = 0.0, ipo: bool = False,
                  device=None):
    """Returns step(state, batch) -> (state, metrics) for the policy
    `model`, held to `ref_model` (set here to no grad and eval). batch:
    the chosen plans (src_type, tok_id, target, seq_len), the rejected
    ones under the same keys with the suffix _rej, and spk_emb or
    reference_mel (+ reference_mel_len), on the models' device. Metrics:
    dpo/loss, dpo/chosen_reward, dpo/rejected_reward (batch means) and
    dpo/reward_acc (the share with chosen above rejected). Both models
    must live on `device` (default cuda, which raises without a GPU)."""
    dev = resolve_device(device)
    check_on(model, dev, "the policy")
    check_on(ref_model, dev, "the reference policy")
    ref_model.requires_grad_(False).eval()

    def step(state: steps.TrainState, batch):
        group = state.dp_group
        with torch.no_grad():
            ref_chosen, ref_rej = _seq_logps(ref_model, batch)
        chosen, rej = _seq_logps(model, batch)
        loss, cr, rr = losses.dpo_loss(chosen, rej, ref_chosen, ref_rej,
                                       beta, label_smoothing, ipo,
                                       group=group)
        steps.backward_and_update(state, loss)
        n = losses.global_count(torch.tensor(cr.shape[0], device=cr.device),
                                group)
        return state, steps.dp_sum(state, {
            "dpo/loss": loss.detach(),
            "dpo/chosen_reward": cr.detach().sum() / n,
            "dpo/rejected_reward": rr.detach().sum() / n,
            "dpo/reward_acc": (cr > rr).float().sum() / n})

    return step
