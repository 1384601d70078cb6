"""Batched TTS serving daemon.

Port of minimax_speech_tpu/cli/serve.py: an HTTP front door queues
requests, and a background worker either batches what arrived within
`max_wait_ms` (up to `max_batch` requests) into one batched synthesis
(infer/serving.py), or feeds a continuous batcher whose lanes requests
join and leave (infer/continuous.py).

  python -m minimax_speech_torch.cli.serve --port 7860 \
      [--ckpt_dir DIR | --random_init] [--config ...] [--device cpu]

POST /synthesize {"text": "...", "speaker": "<id>"}        -> wav bytes
POST /register_speaker {"id": "...", "wav_b64": <base64 wav bytes>,
                        "prompt_text": "..."}               -> 200
GET  /healthz                                               -> ok

A speaker's audio comes in the request (base64 WAV), never as a path on
the server. The server binds 127.0.0.1 unless --host says otherwise and
runs on CUDA unless --device names another device. PyTorch's modules are
not safe to drive from two threads at once, so every use of the pipeline
(the worker's synthesis and a handler's speaker registration) holds the
server's lock.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
import time
import traceback
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

SUBMIT_TIMEOUT_S = 600


def wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16)
                      .tobytes())
    return buf.getvalue()


class _Worker:
    """A request queue drained by one thread until close(); callers wait
    on their own slot."""

    def __init__(self, tts):
        self.tts = tts
        self.lock = threading.Lock()  # every use of the pipeline
        self.queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def close(self, timeout: float = 30.0):
        self._stop.set()
        self._thread.join(timeout)

    def submit(self, text: str, speaker: str) -> np.ndarray:
        done = threading.Event()
        slot: dict = {}
        self.queue.put((text, speaker, slot, done))
        if not done.wait(timeout=SUBMIT_TIMEOUT_S):
            raise RuntimeError("timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["audio"]

    def register(self, prompt_text: str, audio: np.ndarray, spk_id: str):
        with self.lock:
            self.tts.add_zero_shot_spk(prompt_text, audio, spk_id)

    def _request(self, text, speaker, slot, done):
        """The Request for a queued item, or None after answering it with
        an error (an unknown speaker)."""
        from minimax_speech_torch.infer.serving import request_from_info
        try:
            return request_from_info(self.tts, text,
                                     self.tts.spk2info[speaker])
        except KeyError:
            slot["error"] = f"bad request: unknown speaker {speaker!r}"
            done.set()
            return None

    def _worker(self):
        raise NotImplementedError


class Server(_Worker):
    """Arrival-window batching: one batched synthesis per window."""

    def __init__(self, tts, max_batch: int = 8, max_wait_ms: int = 50):
        from minimax_speech_torch.infer.serving import BatchSynthesizer
        self.synth = BatchSynthesizer(tts.pipeline)
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._counter = 0
        super().__init__(tts)

    def _worker(self):
        import torch
        while not self._stop.is_set():
            try:
                batch = [self.queue.get(timeout=0.1)]
            except queue.Empty:
                continue
            deadline = time.time() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            reqs, slots = [], []
            for item in batch:
                r = self._request(*item)
                if r is not None:
                    reqs.append(r)
                    slots.append(item[2:])
            if not reqs:
                continue
            self._counter += 1
            try:
                with self.lock:
                    gen = torch.Generator(device=self.tts.pipeline.device)
                    wavs = self.synth.synthesize_batch(
                        reqs, generator=gen.manual_seed(self._counter))
                for (slot, done), wav in zip(slots, wavs):
                    slot["audio"] = wav
                    done.set()
            except Exception as e:  # the worker must outlive a bad batch
                traceback.print_exc()
                for slot, done in slots:
                    slot["error"] = str(e)
                    done.set()


class ContinuousServer(_Worker):
    """Continuous batching: requests join and leave the running decode, so
    a request's latency does not wait on its batch-mates."""

    def __init__(self, tts, slots: int = 4, token_hop: int = 25):
        import torch

        from minimax_speech_torch.infer.continuous import ContinuousBatcher
        self.cb = ContinuousBatcher(
            tts.pipeline, slots=slots, token_hop=token_hop,
            generator=torch.Generator(
                device=tts.pipeline.device).manual_seed(0))
        self._waiters: dict[int, tuple[dict, threading.Event, list]] = {}
        super().__init__(tts)

    def _drain_queue(self, block: bool):
        while True:
            try:
                item = self.queue.get(timeout=0.02 if block else 0)
            except queue.Empty:
                return
            block = False
            r = self._request(*item)
            if r is None:
                continue
            slot, done = item[2:]
            try:
                rid = self.cb.submit(r)
            except ValueError as e:  # too long for the pool
                slot["error"] = f"bad request: {e}"
                done.set()
                continue
            self._waiters[rid] = (slot, done, [])

    def _worker(self):
        while not self._stop.is_set():
            self._drain_queue(block=not self.cb.busy())
            if not self.cb.busy():
                continue
            try:
                with self.lock:
                    events = self.cb.tick()
            except Exception as e:  # the worker must outlive a bad tick
                traceback.print_exc()
                for slot, done, _ in self._waiters.values():
                    slot["error"] = str(e)
                    done.set()
                self._waiters.clear()
                continue
            for ev in events:
                w = self._waiters.get(ev.stream)
                if w is None:
                    continue
                slot, done, chunks = w
                if len(ev.audio):
                    chunks.append(ev.audio)
                if ev.final:
                    slot["audio"] = (np.concatenate(chunks) if chunks
                                     else np.zeros(0, np.float32))
                    done.set()
                    del self._waiters[ev.stream]


def decode_wav_b64(data: str) -> np.ndarray:
    """Base64 16-bit PCM WAV -> mono float32 at 16 kHz; raises ValueError
    (or binascii.Error, a ValueError) on a bad payload."""
    raw = base64.b64decode(data, validate=True)
    try:
        with wave.open(io.BytesIO(raw), "rb") as w:
            sr, nch = w.getframerate(), w.getnchannels()
            if w.getsampwidth() != 2:
                raise ValueError("expected 16-bit PCM wav")
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    except (wave.Error, EOFError) as e:
        raise ValueError(str(e)) from e
    audio = (pcm.reshape(-1, nch).mean(axis=1) / 32768.0).astype(np.float32)
    if sr != 16000:
        n = int(round(len(audio) * 16000 / sr))
        audio = np.interp(np.linspace(0, 1, n, endpoint=False),
                          np.linspace(0, 1, len(audio), endpoint=False),
                          audio).astype(np.float32)
    return audio


def make_handler(server: _Worker, tts):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, body: bytes, content_type: str = "text/plain"):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(b"ok")
            else:
                self.send_error(404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self.send_error(400, "invalid json")
                return
            if not isinstance(req, dict):
                self.send_error(400, "expected a json object")
                return
            if self.path == "/register_speaker":
                if "id" not in req or "wav_b64" not in req:
                    self.send_error(
                        400, "register_speaker requires 'id' and 'wav_b64'")
                    return
                try:
                    audio = decode_wav_b64(req["wav_b64"])
                except (ValueError, TypeError) as e:
                    self.send_error(400, f"bad wav payload: {e}")
                    return
                server.register(req.get("prompt_text", ""), audio,
                                str(req["id"]))
                self._reply(b"ok")
            elif self.path == "/synthesize":
                try:
                    audio = server.submit(req.get("text", "hello"),
                                          req.get("speaker"))
                except RuntimeError as e:
                    self.send_error(500, str(e))
                    return
                self._reply(wav_bytes(audio, tts.sample_rate), "audio/wav")
            else:
                self.send_error(404)

        def log_message(self, fmt, *a):
            print("[serve]", fmt % a, flush=True)

    return Handler


def build_server(args):
    """The HTTP server, its worker and a line naming the scheduler, from
    parsed flags."""
    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.infer.api import TTS
    from minimax_speech_torch.infer.pipeline import TTSPipeline

    if args.ckpt_dir:
        tts = TTS(model_dir=args.ckpt_dir, tokenizer_path=args.tokenizer_path,
                  config=args.config, device=args.device)
    elif args.random_init:
        cfg = cfg_lib.load_tts_config(args.config, args.override)
        tts = TTS(pipeline=TTSPipeline.from_random(cfg, device=args.device),
                  tokenizer_path=args.tokenizer_path)
    else:
        raise SystemExit("need --ckpt_dir or --random_init")
    if args.warm:
        from minimax_speech_torch.infer.warmup import warm_serving
        t0 = time.time()
        warm_serving(tts, scheduler=args.scheduler, max_batch=args.max_batch,
                     slots=args.slots)
        print(f"warmup finished in {time.time() - t0:.1f}s; ready to serve",
              flush=True)
    if args.scheduler == "continuous":
        server = ContinuousServer(tts, slots=args.slots)
        mode = f"continuous, {args.slots} slots"
    else:
        server = Server(tts, args.max_batch, args.max_wait_ms)
        mode = f"batch<={args.max_batch}, window {args.max_wait_ms}ms"
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(server, tts))
    return httpd, server, mode


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; set 0.0.0.0 "
                        "explicitly to expose)")
    p.add_argument("--config", default="configs/default.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=int, default=50)
    p.add_argument("--scheduler", choices=("window", "continuous"),
                   default="window",
                   help="window = arrival-window batch; continuous = "
                        "slot-pool continuous batching (requests "
                        "join/leave the running decode)")
    p.add_argument("--slots", type=int, default=4,
                   help="(continuous) decode lanes")
    p.add_argument("--warm", dest="warm", action="store_true", default=True,
                   help="run the serving paths once before binding the port "
                        "(default): the kernel build, CUDA context, cuBLAS "
                        "handles and allocator pools are ready by the first "
                        "request")
    p.add_argument("--no_warm", dest="warm", action="store_false")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    httpd, server, mode = build_server(parse_args(argv))
    host, port = httpd.server_address[:2]
    print(f"serving on {host}:{port} ({mode})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
