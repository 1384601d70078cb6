"""Matcha-TTS training CLI.

Port of minimax_speech_tpu/cli/train_matcha.py: the MatchaTTS losses
(dur + prior + CFM, models/matcha.py) over a wav + txt data list,
through train/steps.make_matcha_train_step and the AdamW of
train/schedule.py:

  python -m minimax_speech_torch.cli.train_matcha \\
      --train_data data.list --model_dir exp/matcha --num_epochs 100 \\
      [--device cpu]

Each wav has its text in a .txt beside it; the text rides the tacotron
symbol pipeline (infer/matcha_text.py) and the mel is the 22050 Hz /
1024 / 256 spectrogram computed on the host (ops/mel.hifigan_log_mel_np,
after a linear resample to 22050 Hz), normalised by the corpus's mean
and std, which go to <model_dir>/matcha_stats.json. Tokens and mels pad
to multiples of 32. Every --log_interval steps a row of loss, dur,
prior and cfm goes to matcha_metrics.jsonl; the weights go to
matcha.npz (the JAX package's format) every --save_epochs epochs and at
the end. The model is MatchaConfig() at random weights from --seed; the
CFM draws of the steps come from a host generator seeded with --seed
(the same numbers on every device), the batch order from numpy's. Runs
on --device (default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np


def _bucket(n: int, step: int = 32) -> int:
    return max(step, ((n + step - 1) // step) * step)


def load_corpus(train_data: str, cleaners) -> list:
    """[(token ids int32, mel (frames, 80) float32)] of each wav in the
    list file and its .txt."""
    from minimax_speech_torch.data.pipeline import _load_audio, linear_resample
    from minimax_speech_torch.infer.matcha_text import process_text
    from minimax_speech_torch.ops.mel import hifigan_log_mel_np

    items = []
    for line in Path(train_data).read_text().splitlines():
        if not line.strip():
            continue
        w = Path(line.strip())
        seq, _ = process_text(w.with_suffix(".txt").read_text().strip(),
                              cleaners)
        audio, sr = _load_audio(str(w))
        mel = hifigan_log_mel_np(linear_resample(audio, sr, 22050),
                                 n_fft=1024, n_mels=80, sr=22050, hop=256,
                                 win_length=1024).T
        items.append((np.asarray(seq, np.int32), mel.astype(np.float32)))
    return items


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_data", required=True,
                   help="list file: one wav path per line, .txt sidecars")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--save_epochs", type=int, default=50)
    p.add_argument("--cleaners", default="english_cleaners2",
                   help="comma list (english_cleaners2 falls back to "
                        "grapheme mode when espeak is unavailable)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export_npz", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch.models import cfm
    from minimax_speech_torch.models.matcha import MatchaConfig, MatchaTTS
    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model_dir = Path(args.model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    items = load_corpus(args.train_data, tuple(args.cleaners.split(",")))
    assert items, "empty data list"

    # corpus-level mel normalisation
    allm = np.concatenate([m for _, m in items], axis=0)
    stats = {"mel_mean": float(allm.mean()), "mel_std": float(allm.std())}
    (model_dir / "matcha_stats.json").write_text(json.dumps(stats))
    items = [(t, (m - stats["mel_mean"]) / max(stats["mel_std"], 1e-5))
             for t, m in items]
    tok_pad = _bucket(max(len(t) for t, _ in items))
    mel_pad = _bucket(max(m.shape[0] for _, m in items))

    cfg = MatchaConfig()
    model = params_io.init_params(MatchaTTS(cfg),
                                  torch.Generator().manual_seed(args.seed))
    model.to(device)
    state = steps.make_train_state(model, schedule.make_optimizer(
        lr=args.lr, warmup_steps=args.warmup_steps))
    train_step = steps.make_matcha_train_step(model, device=device)
    draw_gen = torch.Generator().manual_seed(args.seed)

    def make_batch(idx):
        tokens = np.zeros((len(idx), tok_pad), np.int64)
        mels = np.zeros((len(idx), mel_pad, cfg.n_feats), np.float32)
        for j, i in enumerate(idx):
            t, m = items[i]
            tokens[j, :len(t)] = t
            mels[j, :m.shape[0]] = m
        lens = [[len(items[i][0]) for i in idx],
                [items[i][1].shape[0] for i in idx]]
        return {"tokens": torch.as_tensor(tokens, device=device),
                "token_len": torch.tensor(lens[0], device=device),
                "mels": torch.as_tensor(mels, device=device),
                "mel_len": torch.tensor(lens[1], device=device)}

    def draws_for(b: int):
        d = cfm.make_draws(cfg.cfm, b, mel_pad, cfg.n_feats, draw_gen)
        return dataclasses.replace(
            d, t=d.t.to(device), cand=d.cand.to(device),
            keep=d.keep.to(device), perm=d.perm.to(device))

    rng = np.random.default_rng(args.seed)
    step_no = 0
    t0 = time.perf_counter()
    with (model_dir / "matcha_metrics.jsonl").open("a") as mf:
        for epoch in range(args.num_epochs):
            order = rng.permutation(len(items))
            for s in range(0, len(order), args.batch_size):
                idx = order[s: s + args.batch_size]
                state, m = train_step(state, make_batch(idx),
                                      draws_for(len(idx)))
                step_no += 1
                if step_no % args.log_interval == 0:
                    vals = {k: float(v) for k, v in m.items()}
                    row = {"step": step_no, "epoch": epoch, **vals,
                           "elapsed_s": round(time.perf_counter() - t0, 1)}
                    mf.write(json.dumps(row) + "\n")
                    mf.flush()
                    print(f"[matcha step {step_no}] " + " ".join(
                        f"{k}={v:.4f}" for k, v in vals.items()), flush=True)
            if (epoch + 1) % args.save_epochs == 0 \
                    or epoch == args.num_epochs - 1:
                params_io.save_params(str(model_dir / "matcha.npz"), model)
    if args.export_npz:
        params_io.save_params(args.export_npz, model)
    print(f"matcha training done: {step_no} steps")
    return step_no


if __name__ == "__main__":
    main()
