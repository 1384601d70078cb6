"""Listening-test (preference) server: MUSHRA / ABX.

Port of minimax_speech_tpu/utils/preference.py, the same stdlib code: a
`Samples` walker over condition folders, per-user completion filtering,
CSV result appending, and a dependency-free HTTP server rendering the
test pages with <audio> players. The same seed gives the same blind
order as the JAX package (both shuffle with random.Random(seed)), and the
same requests write the same CSV.

Layout: `folder/<condition>/<name>.wav`. Every condition directory holds
identically-named samples; one test page presents all conditions of one
sample (optionally anchored by a `reference` condition shown first,
MUSHRA-style), in shuffled order so raters are blind to condition
identity. The server binds the loopback address unless told otherwise.

  python -m minimax_speech_torch.utils.preference --folder tests_dir \
      --save results.csv [--mode abx] [--reference ref] [--port 7860]
"""
from __future__ import annotations

import argparse
import csv
import html
import json
import random
import urllib.parse
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

AUDIO_EXTS = (".wav", ".flac", ".mp3")


def find_audio(folder) -> List[Path]:
    return sorted(p for p in Path(folder).rglob("*")
                  if p.suffix.lower() in AUDIO_EXTS)


class Samples:
    """Walk `folder/<condition>/<name>` into per-sample condition maps."""

    def __init__(self, folder: str, shuffle: bool = True,
                 n_samples: Optional[int] = None, seed: Optional[int] = None):
        samples: dict = defaultdict(dict)
        for f in find_audio(folder):
            samples[f.name][f.parent.stem] = f
        self.samples = dict(samples)
        self.names = list(self.samples.keys())
        self.filtered = False
        self.current = 0
        self.order: List[str] = []
        if shuffle:
            random.Random(seed).shuffle(self.names)
        self.n_samples = len(self.names) if n_samples is None else n_samples

    def conditions(self) -> List[str]:
        conds: set = set()
        for m in self.samples.values():
            conds |= set(m)
        return sorted(conds)

    def __len__(self):
        return self.n_samples

    def progress(self) -> str:
        return f"On {self.current} / {len(self)} samples"

    def filter_completed(self, user: str, save_path: str):
        """Drop samples this user already rated (resume support). Runs
        once per session."""
        if self.filtered:
            return
        done = []
        if Path(save_path).exists():
            with open(save_path, newline="") as f:
                done = [r["sample"] for r in csv.DictReader(f)
                        if r.get("user") == user]
        self.names = [k for k in self.names if k not in done]
        self.names = self.names[: self.n_samples]
        self.filtered = True

    def get_next_sample(self, reference: Optional[str],
                        conditions: List[str], seed: Optional[int] = None):
        """Next sample's file list in BLIND order: conditions shuffled,
        optional reference anchored first. Returns the files, or None
        when exhausted."""
        conditions = list(conditions)
        random.Random(seed).shuffle(conditions)
        self.order = ([reference] + conditions if reference is not None
                      else conditions)
        if self.current >= min(len(self.names), len(self)):
            return None
        key = self.names[self.current]
        self.current += 1
        return [self.samples[key][o] for o in self.order]


def save_result(result: dict, save_path: str):
    """Append one rating row; header written on first use."""
    with open(save_path, mode="a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=sorted(result.keys()))
        if f.tell() == 0:
            writer.writeheader()
        writer.writerow(result)


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>Listening test</title><style>
body {{ font-family: sans-serif; max-width: 840px; margin: 2em auto; }}
.cond {{ margin: 1em 0; padding: 1em; border: 1px solid #ccc; }}
.slider {{ width: 300px; }}</style></head><body>
<h2>Listening test ({mode})</h2><p>{progress}</p>
<form method="post" action="/rate">
<input type="hidden" name="sample" value="{sample}">
<input type="hidden" name="order" value="{order}">
<input type="hidden" name="user" value="{user}">
{blocks}
<button type="submit">Submit &amp; next</button></form></body></html>"""

_BLOCK = """<div class="cond"><b>{label}</b><br>
<audio controls preload="none" src="/audio?f={src}"></audio><br>
{control}</div>"""


class _Handler(BaseHTTPRequestHandler):
    app = None  # injected

    def log_message(self, *a):  # quiet
        pass

    def _send(self, body: bytes, ctype: str = "text/html"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(url.query)
        app = self.app
        if url.path == "/audio":
            f = Path(q["f"][0])
            if f not in app.allowed:
                self.send_error(403)
                return
            self._send(f.read_bytes(), "audio/wav")
            return
        user = q.get("user", ["anon"])[0]
        app.samples.filter_completed(user, app.save_path)
        files = app.samples.get_next_sample(app.reference, app.conditions)
        if files is None:
            self._send(b"<html><body><h2>No more samples!</h2>"
                       b"</body></html>")
            return
        blocks = []
        for i, f in enumerate(files):
            is_ref = app.reference is not None and i == 0
            label = "Reference" if is_ref else f"Condition {i}"
            if is_ref:
                control = ""
            elif app.mode == "mushra":
                control = (f'<input class="slider" type="range" min="0" '
                           f'max="100" value="50" name="score_{i}"> 0-100')
            else:
                control = (f'<input type="radio" name="pick" '
                           f'value="{i}"> prefer this one')
            blocks.append(_BLOCK.format(label=html.escape(label),
                                        src=urllib.parse.quote(str(f)),
                                        control=control))
        page = _PAGE.format(mode=app.mode, progress=app.samples.progress(),
                            sample=html.escape(files[-1].name),
                            order=html.escape(json.dumps(
                                app.samples.order)),
                            user=html.escape(user),
                            blocks="\n".join(blocks))
        self._send(page.encode())

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        form = urllib.parse.parse_qs(self.rfile.read(n).decode())
        app = self.app
        order = json.loads(form["order"][0])
        row = {"user": form.get("user", ["anon"])[0],
               "sample": form["sample"][0]}
        for k, v in form.items():
            if k.startswith("score_"):
                row[order[int(k.split("_")[1])]] = v[0]
        if "pick" in form:
            row["preference"] = order[int(form["pick"][0])]
        save_result(row, app.save_path)
        self.send_response(303)
        self.send_header("Location",
                         f"/?user={urllib.parse.quote(row['user'])}")
        self.end_headers()


class PreferenceApp:
    """Bundles the test state; `serve()` blocks, `make_server()` returns
    the (bound) ThreadingHTTPServer for tests."""

    def __init__(self, folder: str, save_path: str, mode: str = "mushra",
                 reference: Optional[str] = None,
                 n_samples: Optional[int] = None, seed: Optional[int] = None):
        assert mode in ("mushra", "abx")
        self.samples = Samples(folder, n_samples=n_samples, seed=seed)
        self.save_path = save_path
        self.mode = mode
        self.reference = reference
        conds = self.samples.conditions()
        self.conditions = [c for c in conds if c != reference]
        self.allowed = {f for m in self.samples.samples.values()
                        for f in m.values()}

    def make_server(self, host: str = "127.0.0.1", port: int = 0):
        handler = type("Handler", (_Handler,), {"app": self})
        return ThreadingHTTPServer((host, port), handler)

    def serve(self, host: str = "127.0.0.1", port: int = 7860):
        srv = self.make_server(host, port)
        print(f"listening test at http://{host}:{srv.server_port}/")
        srv.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--folder", required=True,
                   help="condition folders with identically-named wavs")
    p.add_argument("--save", required=True, help="results CSV")
    p.add_argument("--mode", choices=["mushra", "abx"], default="mushra")
    p.add_argument("--reference", default=None,
                   help="condition shown first as the anchor")
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--port", type=int, default=7860)
    args = p.parse_args(argv)
    PreferenceApp(args.folder, args.save, args.mode, args.reference,
                  args.n_samples).serve(port=args.port)


if __name__ == "__main__":
    main()
