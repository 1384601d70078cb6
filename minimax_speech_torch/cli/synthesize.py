"""Zero-shot synthesis CLI: text + prompt wav -> 24 kHz wav.

Port of minimax_speech_tpu/cli/synthesize.py:

  python -m minimax_speech_torch.cli.synthesize \
      --text "hello there" --prompt_text "reference transcript" \
      --prompt_wav prompt24k.wav --out out.wav \
      [--ckpt_dir DIR | --random_init] [--stream] [--device cpu]

ckpt_dir holds {llm,flow,codec,s3}.npz in the JAX package's format
(codec.npz: the DAC-VAE's, or HiFT's with --override
model.output_type=mel).
Runs on CUDA unless --device names another device. Without --prompt_wav
a 3 s 220 Hz tone is the prompt, without --text "Hello there.".
"""
from __future__ import annotations

import argparse
import time
import wave
from pathlib import Path

import numpy as np

SAMPLE_RATE = 24000


def write_wav(path: str, audio: np.ndarray, sr: int = SAMPLE_RATE):
    pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def tone(seconds: float = 3.0, sr: int = SAMPLE_RATE) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    return (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--text", default="Hello there.")
    p.add_argument("--prompt_text", default="")
    p.add_argument("--prompt_wav", default=None,
                   help="24 kHz mono wav of the reference speaker")
    p.add_argument("--out", default="out.wav")
    p.add_argument("--config", default="configs/default.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.data.pipeline import _load_audio
    from minimax_speech_torch.infer.frontend import Frontend
    from minimax_speech_torch.infer.pipeline import TTSPipeline
    from minimax_speech_torch.infer.session import StreamingSession
    from minimax_speech_torch.utils.params_io import load_params

    cfg = cfg_lib.load_tts_config(args.config, args.override)
    if args.ckpt_dir:
        d = Path(args.ckpt_dir)
        pipe = TTSPipeline.from_flax(
            cfg, *(load_params(d / f"{n}.npz")
                   for n in ("llm", "flow", "codec", "s3")),
            device=args.device)
    elif args.random_init:
        pipe = TTSPipeline.from_random(cfg, seed=args.seed,
                                       device=args.device)
    else:
        raise SystemExit("need --ckpt_dir or --random_init")
    fe = Frontend(args.tokenizer_path)

    if args.prompt_wav:
        audio24, sr = _load_audio(args.prompt_wav)
        if sr != SAMPLE_RATE:
            raise SystemExit(f"the prompt must be 24 kHz (got {sr})")
    else:
        audio24 = tone()
    # 16 kHz copy for the FSQ tokenizer
    n16 = int(len(audio24) * 16000 / SAMPLE_RATE)
    audio16 = np.interp(np.linspace(0, 1, n16, endpoint=False),
                        np.linspace(0, 1, len(audio24), endpoint=False),
                        audio24).astype(np.float32)

    prompt_tokens = pipe.extract_prompt_tokens(audio16)
    prompt_mel = pipe.extract_prompt_mel(audio24)
    prompt_feat = pipe.extract_prompt_feat(audio24)
    lm_spk, flow_emb = pipe.speaker_embedding(prompt_mel)
    ptext_tokens = fe.extract_text_tokens(args.prompt_text) \
        if args.prompt_text else np.zeros((0,), np.int32)

    outputs = []
    t0 = time.perf_counter()
    for piece in fe.text_normalize(args.text):
        text_tokens = fe.extract_text_tokens(piece)
        gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
        if args.stream:
            sess = StreamingSession(pipe)
            for chunk in sess.synthesize_stream(
                    text_tokens, ptext_tokens, prompt_tokens, prompt_feat,
                    lm_spk, flow_emb, generator=gen):
                outputs.append(chunk.audio)
                print(f"chunk: {len(chunk.audio) / SAMPLE_RATE:.2f}s "
                      f"(tokens={chunk.tokens}, final={chunk.final})")
        else:
            wav, tim = pipe.synthesize(
                text_tokens, ptext_tokens, prompt_tokens, prompt_feat,
                lm_spk, flow_emb, generator=gen, return_timings=True)
            outputs.append(wav)
            rtf = tim["total_s"] / max(tim["audio_s"], 1e-9)
            print(f"piece: {tim['audio_s']:.2f}s audio, rtf={rtf:.4f}")
    total = np.concatenate(outputs) if outputs else np.zeros(1, np.float32)
    write_wav(args.out, total)
    dt = time.perf_counter() - t0
    print(f"wrote {args.out}: {len(total) / SAMPLE_RATE:.2f}s audio in "
          f"{dt:.2f}s (rtf={dt / max(len(total) / SAMPLE_RATE, 1e-9):.4f})")
    return total


if __name__ == "__main__":
    main()
