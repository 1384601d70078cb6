"""Matcha-TTS CLI: text -> mel -> HiFi-GAN -> denoiser -> wav.

Port of minimax_speech_tpu/cli/matcha.py:

  python -m minimax_speech_torch.cli.matcha --text "hello" \\
      --output_folder out/ [--ckpt matcha.npz --vocoder_ckpt voc.npz] \\
      [--file texts.txt --batched --batch_size 32] [--device cpu]

Text goes through infer/matcha_text.process_text (pad ids interspersed);
token sequences pad to the buckets (64, 128, 256, 384, 512), or on to a
multiple of 128, and --batched stacks up to --batch_size texts into one
padded batch. Each utterance writes utterance_NNN.wav, its mel
(_mel.npy) and, where matplotlib imports, a spectrogram png; each line
reports its real-time factor (RTF: synthesis seconds per audio second,
the batch's shared by its utterances), and the last line is a JSON
summary (n, rtf_mean, wall, and the seconds spent in the acoustic model,
the HiFi-GAN and the denoiser). The synthesis noise of a batch is drawn
on the host from --seed plus the batch's first index, so a run gives the
same mels on every device. Without --ckpt (--random_init) the model has
--hidden and --n_layers at random weights from --seed, the vocoder from
--seed + 1. Runs on --device (default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

BUCKETS = (64, 128, 256, 384, 512)


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def save_spectrogram_png(mel: np.ndarray, path: str):
    """A spectrogram image of mel (frames, channels), if matplotlib
    imports."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(mel.T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.title("Synthesised Mel-Spectrogram")
    fig.savefig(path)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser(description="Matcha-TTS")
    p.add_argument("--text", default=None)
    p.add_argument("--file", default=None, help="text file, one per line")
    p.add_argument("--ckpt", default=None, help="matcha params .npz")
    p.add_argument("--vocoder_ckpt", default=None,
                   help="HiFi-GAN generator params .npz")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--temperature", type=float, default=0.667)
    p.add_argument("--speaking_rate", type=float, default=0.95)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--denoiser_strength", type=float, default=0.00025)
    p.add_argument("--output_folder", default=".")
    p.add_argument("--batched", action="store_true")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--cleaners", default="english_cleaners2")
    p.add_argument("--max_frames", type=int, default=1000)
    p.add_argument("--sample_rate", type=int, default=22050)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_vocab", type=int, default=178)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.text and not args.file:
        raise SystemExit("need --text or --file")
    if not args.random_init and not args.ckpt:
        raise SystemExit("need --ckpt (or --random_init for smoke runs)")

    import torch

    from minimax_speech_torch.cli.synthesize import write_wav
    from minimax_speech_torch.infer import matcha_text
    from minimax_speech_torch.models.matcha import (MatchaConfig, MatchaTTS,
                                                    matcha_synthesise)
    from minimax_speech_torch.models.matcha_hifigan import (
        Denoiser, MatchaHiFiGAN, MatchaHiFiGANConfig)
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    out_dir = Path(args.output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = ([args.text] if args.text else
             [ln.strip() for ln in open(args.file) if ln.strip()])
    cleaners = tuple(args.cleaners.split(","))

    cfg = (MatchaConfig(n_vocab=args.n_vocab, hidden=args.hidden,
                        n_layers=args.n_layers) if args.random_init
           else MatchaConfig(n_vocab=args.n_vocab))
    voc_cfg = MatchaHiFiGANConfig(in_channels=cfg.n_feats)
    model, vocoder = MatchaTTS(cfg), MatchaHiFiGAN(voc_cfg)
    for module, ckpt, seed in ((model, args.ckpt, args.seed),
                               (vocoder, args.vocoder_ckpt, args.seed + 1)):
        if ckpt:
            params_io.load_flax_params(module, params_io.load_params(ckpt))
        else:
            params_io.init_params(module, torch.Generator().manual_seed(seed))
        module.to(device).eval()
    denoiser = Denoiser(vocoder, mel_frames=88, n_mels=cfg.n_feats,
                        device=device)
    hop = voc_cfg.hop_length
    spent = {"acoustic_s": 0.0, "vocoder_s": 0.0, "denoiser_s": 0.0}

    def clock(key: str, t0: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        spent[key] += t - t0
        return t

    @torch.no_grad()
    def synth_batch(seqs: list[list[int]], base_idx: int):
        tokens = np.zeros((len(seqs), _bucket(max(len(s) for s in seqs))),
                          np.int64)
        lens = np.array([len(s) for s in seqs])
        for i, s in enumerate(seqs):
            tokens[i, :len(s)] = s
        z = torch.randn((len(seqs), args.max_frames, cfg.n_feats),
                        generator=torch.Generator().manual_seed(
                            args.seed + base_idx))
        t0 = time.perf_counter()
        mel, y_len = matcha_synthesise(
            model, tokens, lens, z=z, n_timesteps=args.steps,
            length_scale=args.speaking_rate, max_frames=args.max_frames,
            temperature=args.temperature, device=device)
        t1 = clock("acoustic_s", t0)
        wav = vocoder(mel)
        dt = clock("vocoder_s", t1) - t0
        results = []
        for i, n in enumerate(y_len.tolist()):
            t2 = time.perf_counter()
            a = denoiser(wav[i, :n * hop], args.denoiser_strength)[:n * hop]
            clock("denoiser_s", t2)
            a = a.cpu().numpy()
            rtf = dt / max(len(a) / args.sample_rate, 1e-6) / len(seqs)
            results.append((mel[i, :n].cpu().numpy(), a, rtf))
        return results

    t_start = time.perf_counter()
    rtfs = []
    idx = 0
    batches = ([texts[i:i + args.batch_size]
                for i in range(0, len(texts), args.batch_size)]
               if args.batched else [[t] for t in texts])
    for batch in batches:
        seqs = []
        for text in batch:
            seq, phones = matcha_text.process_text(text, cleaners)
            print(f"[{idx + len(seqs)}] - Input text: {text}")
            print(f"[{idx + len(seqs)}] - Phonetised text: {phones[1::2]}")
            seqs.append(seq)
        for m, a, rtf in synth_batch(seqs, idx):
            name = f"utterance_{idx:03d}"
            write_wav(str(out_dir / f"{name}.wav"), a, args.sample_rate)
            np.save(out_dir / f"{name}_mel.npy", m)
            save_spectrogram_png(m, str(out_dir / f"{name}.png"))
            print(f"[{idx}] - RTF: {rtf:.4f}")
            rtfs.append(rtf)
            idx += 1
    summary = {"n": idx, "rtf_mean": float(np.mean(rtfs)),
               "wall": round(time.perf_counter() - t_start, 2),
               **{k: round(v, 4) for k, v in spent.items()}}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
