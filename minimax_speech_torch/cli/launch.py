"""Elastic gang launcher: one worker process per rank (per GPU).

Port of minimax_speech_tpu/cli/launch.py. It spawns `--nproc` workers,
each given the coordinator address (a free loopback port), the world
size and its rank (--distributed --coordinator --num_processes
--process_id), and watches the gang. A synchronous gang cannot survive
losing a member, so when any rank fails the launcher kills the others
and relaunches the whole gang on a fresh port, up to --max_restarts
times; the workers resume from their latest checkpoint (cli/train.py
resumes from --model_dir). The attempt number reaches each worker in
the environment variable MSTORCH_RESTART_COUNT.

  python -m minimax_speech_torch.cli.launch --nproc 2 --max_restarts 3 \
      [--module minimax_speech_torch.cli.train] [--device cpu] \
      -- --model llm --config configs/tiny.yaml --tp 2 ...

--device goes to the workers (default: theirs, cuda; rank r takes
cuda:(r % device_count)). SIGTERM/SIGINT (a preemption notice) is
forwarded to the gang, which shuts down without a restart. Each rank's
output goes to <log_dir>/rank<r>.attempt<a>.log.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


RESTART_ENV = "MSTORCH_RESTART_COUNT"


def spawn_gang(module: str, worker_args: list[str], nproc: int, port: int,
               attempt: int, device: str | None, log_dir: Path,
               coordinator_host: str) -> list[subprocess.Popen]:
    procs = []
    for rank in range(nproc):
        argv = [sys.executable, "-m", module, *worker_args,
                "--distributed",
                "--coordinator", f"{coordinator_host}:{port}",
                "--num_processes", str(nproc),
                "--process_id", str(rank)]
        if device:
            argv += ["--device", device]
        env = dict(os.environ)
        env[RESTART_ENV] = str(attempt)
        log = log_dir / f"rank{rank}.attempt{attempt}.log"
        f = open(log, "w")
        p = subprocess.Popen(argv, env=env, stdout=f, stderr=f)
        p._log_file = f  # closed in reap()
        p._log_path = log
        procs.append(p)
    return procs


def reap(procs: list[subprocess.Popen], grace: float = 10.0):
    """Terminate every still-running member of a broken gang."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.2)
        if p.poll() is None:
            p.kill()
            p.wait()
    for p in procs:
        f = getattr(p, "_log_file", None)
        if f and not f.closed:
            f.close()


def run_elastic(module: str, worker_args: list[str], nproc: int,
                max_restarts: int = 3, device: str | None = None,
                log_dir: str = "launch_logs", poll_s: float = 0.5,
                coordinator_host: str = "127.0.0.1",
                state_file: str | None = None) -> int:
    """Supervise a gang; returns the final exit code (0 on success)."""
    logd = Path(log_dir)
    logd.mkdir(parents=True, exist_ok=True)
    procs: list[subprocess.Popen] = []
    stopping = False

    def forward(signum, _frame):
        # a preemption notice / Ctrl-C means SHUT DOWN, not "restart the
        # gang": workers checkpoint and exit nonzero, which must not be
        # classified as a rank failure
        nonlocal stopping
        stopping = True
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    old_term = signal.signal(signal.SIGTERM, forward)
    old_int = signal.signal(signal.SIGINT, forward)
    try:
        for attempt in range(max_restarts + 1):
            port = free_port()
            procs = spawn_gang(module, worker_args, nproc, port, attempt,
                               device, logd, coordinator_host)
            if state_file:
                # tmp+rename so concurrent pollers never observe a
                # partially-written file (rename is atomic on POSIX)
                tmp = Path(state_file).with_suffix(".tmp")
                tmp.write_text(json.dumps(
                    {"attempt": attempt, "port": port,
                     "pids": [p.pid for p in procs]}))
                tmp.replace(state_file)
            print(f"[launch] attempt {attempt}: {nproc} ranks on "
                  f"port {port} (logs: {logd})", flush=True)
            failed = None
            while True:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes):
                    failed = [i for i, c in enumerate(codes)
                              if c not in (None, 0)]
                    break
                if all(c == 0 for c in codes):
                    return 0
                time.sleep(poll_s)
            if stopping:
                reap(procs)
                print("[launch] shutdown requested; not restarting",
                      file=sys.stderr)
                return 0
            reap(procs)
            for i in failed:
                tail = Path(procs[i]._log_path).read_text()[-2000:]
                print(f"[launch] rank {i} exited "
                      f"{procs[i].returncode}; log tail:\n{tail}",
                      file=sys.stderr, flush=True)
            if attempt == max_restarts:
                print(f"[launch] giving up after {attempt + 1} attempts",
                      file=sys.stderr)
                return 1
            print(f"[launch] restarting gang (workers resume from their "
                  f"latest checkpoint)", flush=True)
        return 1
    finally:
        reap(procs)
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--module", default="minimax_speech_torch.cli.train")
    p.add_argument("--device", default=None,
                   help="forwarded to workers as --device (cuda or cpu)")
    p.add_argument("--log_dir", default="launch_logs")
    p.add_argument("--coordinator_host", default="127.0.0.1")
    p.add_argument("--state_file", default=None,
                   help="json file updated with {attempt, port, pids} "
                        "each launch (for external monitors/tests)")
    p.add_argument("worker_args", nargs=argparse.REMAINDER,
                   help="args after -- go to the worker module")
    args = p.parse_args(argv)
    wargs = args.worker_args
    if wargs and wargs[0] == "--":
        wargs = wargs[1:]
    raise SystemExit(run_elastic(
        args.module, wargs, args.nproc, args.max_restarts, args.device,
        args.log_dir, coordinator_host=args.coordinator_host,
        state_file=args.state_file))


if __name__ == "__main__":
    main()
