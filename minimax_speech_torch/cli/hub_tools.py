"""Model-hub tools: a model card for a model directory, and its upload.

Port of minimax_speech_tpu/cli/hub_tools.py. The card and the packaging
work offline; `upload` needs the `huggingface_hub` package and a
network, and exits with a message where the package does not import
(the card is written first either way).

  python -m minimax_speech_torch.cli.hub_tools card --model_dir D
  python -m minimax_speech_torch.cli.hub_tools upload --model_dir D \
      --repo user/name [--private]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

CARD_TEMPLATE = """---
library_name: minimax_speech_torch
tags: [text-to-speech, pytorch, cuda, h100, flow-matching, zero-shot]
---

# {name}

Zero-shot TTS model for minimax_speech_torch (PyTorch, with hand-written
CUDA attention kernels for NVIDIA H100). Three-stage pipeline: Qwen2
speech-token LM -> conditional flow matching -> DAC-VAE decoder at
24 kHz.

## Files

{files}

## Usage

```python
from minimax_speech_torch.infer.api import TTS
tts = TTS(model_dir="{name}")
for out in tts.inference_zero_shot(text, prompt_text, prompt_wav_16k):
    ...
```

{metrics}
"""


def make_card(model_dir: Path) -> str:
    files = "\n".join(f"- `{p.name}`" for p in sorted(model_dir.iterdir())
                      if p.is_file())
    metrics = ""
    mfile = model_dir / "metrics.json"
    if mfile.exists():
        rows = json.loads(mfile.read_text())
        metrics = "## Metrics\n\n" + "\n".join(
            f"- {k}: {v}" for k, v in rows.items())
    return CARD_TEMPLATE.format(name=model_dir.name, files=files,
                                metrics=metrics)


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("card")
    c.add_argument("--model_dir", required=True)
    u = sub.add_parser("upload")
    u.add_argument("--model_dir", required=True)
    u.add_argument("--repo", required=True)
    u.add_argument("--private", action="store_true")
    args = p.parse_args(argv)

    model_dir = Path(args.model_dir)
    card = make_card(model_dir)
    (model_dir / "README.md").write_text(card)
    print(f"wrote {model_dir / 'README.md'}")
    if args.cmd == "upload":
        try:
            from huggingface_hub import HfApi
        except ImportError:
            raise SystemExit("huggingface_hub not available in this "
                             "environment (offline); card was generated.")
        api = HfApi()
        api.create_repo(args.repo, private=args.private, exist_ok=True)
        api.upload_folder(folder_path=str(model_dir), repo_id=args.repo)
        print(f"uploaded {model_dir} -> {args.repo}")


if __name__ == "__main__":
    main()
