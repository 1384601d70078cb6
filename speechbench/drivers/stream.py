"""Streaming TTS to independent users: an open loop of requests into
`ContinuousBatcher.run` with a wall clock.

Set-up builds the pipeline with the benchmark's weights, warms one
request through a throwaway pool, then starts the open loop: a lead-in
of `lead_s` (about one request's lifetime) fills the pool to its steady
occupancy, then the window of `--seconds` opens. Arrivals go on past the
window until every request due in it has its first audio (or
`drain_max_s` passes), so the pool's load holds steady to the end.
Times are from when a request was due, so a late submission counts.

Every `greedy_every`-th request decodes greedily (its lanes' noise
zeroed), so that the output check can read the reference's best token
at each of its positions. Once the window has closed the check takes a
seeded sample of the finished greedy requests, with the longest, and
compares: the served tokens' logits against the plain LM over the whole
plan (prefill and cached decode against one pass), each hop's latents
against the plain streaming flow on the same tokens, each hop's PCM
against the plain DAC-VAE on the hop's latents, and the emitted chunks
against the hop-cutting rule applied to each hop's PCM.
"""
from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from speechbench import checks, program, roofline, traffic
from speechbench.stats import percentile

SAMPLE_RATE = 24000
SAMPLES_PER_FRAME = 480


def gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


class StreamRun:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.traffic
        self.model = ctx.config["model"]
        self.serving = ctx.config["serving"]
        self.dev = ctx.device

    # -- set-up ---------------------------------------------------------------
    def batcher(self, pipe, requests, gen):
        """A pool whose decode noise is drawn from `gen`, zeroed for the
        lanes that hold a greedy request."""
        from minimax_speech_torch.infer.continuous import ContinuousBatcher
        mix = self.mix
        lm = pipe.cfg.lm
        slots = mix["slots"]
        holder = {}

        def noise(burst, first_step, n):
            g_top = gumbel((n, slots, lm.top_k), gen, self.dev)
            g_fb = gumbel((n, slots, lm.vocab), gen, self.dev)
            lanes = [i for i, lane in enumerate(holder["b"].lanes)
                     if not lane.free and requests[lane.request_id].greedy]
            if lanes:
                g_top[:, lanes] = 0.0
                g_fb[:, lanes] = 0.0
            return g_top, g_fb

        b = ContinuousBatcher(pipe, slots=slots, token_hop=mix["token_hop"],
                              lookahead=mix["lookahead"],
                              overlap_frames=mix["overlap_frames"],
                              prompt_buckets=tuple(mix["prompt_buckets"]),
                              noise=noise)
        holder["b"] = b
        return b

    def requests(self, pipe, n, seed, stream=1):
        c = pipe.cfg
        return traffic.speech_requests(
            self.mix, n, seed, text_vocab=c.lm.qwen.vocab_size,
            speech_vocab=c.lm.speech_token_size, lm_width=c.lm.llm_input_size,
            feat_dim=c.flow.output_size, spk_dim=c.flow.spk_embed_dim,
            token_latent_ratio=c.token_latent_ratio, stream=stream)

    def warm(self, pipe, seed):
        """One request per prompt bucket the mix uses, through a
        throwaway pool, until each has its first audio: CUDA, cuBLAS and
        the K1 library are up before the loop starts."""
        reqs = self.requests(pipe, 2, seed, stream=9)
        b = self.batcher(pipe, reqs, torch.Generator(self.dev).manual_seed(1))
        for r in reqs:
            b.submit(program.request(r))
        seen = set()
        while len(seen) < len(reqs) and b.busy():
            seen.update(ev.stream for ev in b.tick())
        program.sync(self.dev)

    # -- the run --------------------------------------------------------------
    def run(self, pipe=None, states=None):
        ctx = self.ctx
        mix = self.mix
        seed = ctx.seed
        if pipe is None:
            pipe, states = program.serving_pipeline(self.model, self.serving,
                                                    seed, self.dev)
        self.pipe, self.states = pipe, states
        self.warm(pipe, seed)
        lead, seconds = float(mix["lead_s"]), float(ctx.seconds)
        due = traffic.arrivals(mix, lead + seconds + mix["drain_max_s"])
        reqs = self.requests(pipe, len(due), seed)
        self.reqs = reqs
        gen = torch.Generator(self.dev).manual_seed(int(seed) % (1 << 63))
        b = self.batcher(pipe, reqs, gen)
        self.b = b
        rec = ctx.recorder
        rec.wrap(b, "_burst", "burst")
        rec.wrap(b, "_prefill_into", "prefill", sync=True)
        rec.wrap(pipe, "decode", "codec", sync=True)
        hops = self._capture(b, pipe)
        ticks = self._observe(b)

        first, final = {}, {}
        self.final = final
        samples = defaultdict(int)
        frames = []  # (time, first frame, frames) of each chunk
        first_samples = {}
        self.chunks = defaultdict(list)
        w0, w1 = lead, lead + seconds
        # a traced run's host-timed metrics read the window before the
        # profiler's part, which slows the host (c1 moves to that part's
        # clean edge once the profiler starts, _observe)
        c1 = w1 - mix["trace_s"] if ctx.trace else w1
        self.clean_end = None
        self.window = (w0, c1)
        in_window = [i for i, t in enumerate(due) if w0 <= t < w1]
        t_loop = time.perf_counter()
        self.t_loop = t_loop
        rec.window = (t_loop + w0, t_loop + c1)
        ctx.window_start = t_loop + w0

        def clock():
            return time.perf_counter() - t_loop

        self.clock = clock
        arrivals = [(float(t), program.request(r)) for t, r in zip(due, reqs)]
        gen_run = b.run(arrivals, clock=clock)
        try:
            for t, ev in gen_run:
                rid = ev.stream
                n = len(ev.audio)
                if n and rid not in first:
                    first[rid] = t
                    first_samples[rid] = n
                frames.append((t, reqs[rid].prompt_feat.shape[0]
                               + samples[rid] // SAMPLES_PER_FRAME,
                               n // SAMPLES_PER_FRAME))
                samples[rid] += n
                if reqs[rid].greedy:
                    self.chunks[rid].append(ev.audio)
                if ev.final:
                    final[rid] = t
                    self.final = final
                if t >= w1 and (all(i in first for i in in_window)
                                or t >= w1 + mix["drain_max_s"]):
                    break
        finally:
            gen_run.close()
        t_stop = clock()
        if self.clean_end is not None:
            c1 = min(c1, self.clean_end)
            self.window = (w0, c1)
            rec.window = (t_loop + w0, t_loop + c1)
        program.sync(self.dev)
        ctx.memory_peak_bytes = program.memory_peak(self.dev)
        rec.unwrap()

        # end-to-end metrics
        ttfa = [first.get(i, t_stop) - due[i] for i in in_window]
        failed = sum(1 for i in in_window if i not in first)
        rtf = []
        for rid, tf in final.items():
            if w0 <= tf <= w1 and rid in first:
                after = (samples[rid] - first_samples[rid]) / SAMPLE_RATE
                if after > 0:
                    rtf.append((tf - first[rid]) / after)
        e2e = {"ttfa_p90_s": percentile(ttfa, 90)}
        if rtf:
            e2e["stream_rtf_p90"] = percentile(rtf, 90)
        self.record = {
            "kind": "stream", "window_s": seconds, "clean": (w0, c1),
            "due": due,
            "in_window": in_window, "first": first, "final": final,
            "ticks": ticks, "hops": hops, "t_stop": t_stop,
            "admitted": self.admitted, "lead": lead,
            "token_hop": mix["token_hop"], "ttfa": ttfa, "rtf": rtf,
            "n_requests": len(in_window), "n_rtf": len(rtf),
            "emitted": self.emitted, "frames": frames}
        ctx.attempted, ctx.failed = len(in_window), failed
        return e2e

    # -- observation ----------------------------------------------------------
    def _observe(self, b):
        """Wrap tick: each tick's end time and occupied lanes, each
        request's admission (the end of the tick after which its id
        holds a lane), each lane's new tokens (with their positions, for
        the useful work), and the profiler window's start and stop at
        tick boundaries. When the profiler starts, the clean part of the
        window ends where the tick before it began: a request due before
        then was admitted before the profiler, one due later waits into
        the profiler's part."""
        ctx = self.ctx
        ticks = []
        self.admitted = {}
        self.emitted = []  # (time, plan length + position) per token
        inner = b.tick
        reqs = self.reqs

        def tick():
            before = {lane.request_id: len(lane.tokens) for lane in b.lanes
                      if not lane.free}
            out = inner()
            t = self.clock()
            busy = 0
            for lane in b.lanes:
                if lane.free:
                    continue
                busy += 1
                rid = lane.request_id
                self.admitted.setdefault(rid, t)
                plan = plan_length(reqs[rid])
                for k in range(before.get(rid, 0), len(lane.tokens)):
                    self.emitted.append((t, plan + k))
            ticks.append((t, busy))
            if ctx.tracer is not None:
                # the profiler's window closes the measured one; the
                # host-timed metrics read the part before it
                rel = t - self.mix["lead_s"]
                if not ctx.tracer.active and ctx.tracer.host is None \
                        and rel >= ctx.seconds - self.mix["trace_s"]:
                    self.clean_end = ticks[-2][0] if len(ticks) > 1 else t
                    ctx.tracer.start()
                elif ctx.tracer.active and rel >= ctx.seconds:
                    ctx.tracer.stop()
            return out

        b.tick = tick
        return ticks

    def _capture(self, b, pipe):
        """Wrap the hop (flow_audio) and the codec: each hop's rows, key
        lengths and frames (for K1's work), and for greedy requests the
        hop's token count, latents and PCM, kept on the host."""
        ctx = self.ctx
        rec = ctx.recorder
        hops = []
        self.captured = defaultdict(list)
        last = {}
        dec_inner = pipe.decode

        def decode(feat):
            wav = dec_inner(feat)
            last["feat"] = feat
            return wav

        pipe.decode = decode
        inner = rec.wrap(b, "flow_audio", "hop")

        def flow_audio(seqs, pf, pfl, femb):
            traced = ctx.tracer is not None and ctx.tracer.active
            wav = inner(seqs, pf, pfl, femb)
            feat = last.pop("feat")
            hops.append({"t": self.clock(), "traced": traced,
                         "lens": [len(q) for q in seqs],
                         "frames": int(feat.shape[1])})
            keys = {}
            for lane in b.lanes:
                if not lane.free:
                    key = np.concatenate([
                        np.asarray(lane.request.prompt_speech_tokens,
                                   np.int64),
                        np.asarray(lane.tokens, np.int64)]).tobytes()
                    keys[key] = lane
            for j, q in enumerate(seqs):
                lane = keys.get(np.asarray(q, np.int64).tobytes())
                if lane is None or not self.reqs[lane.request_id].greedy:
                    continue
                n_prompt = len(lane.request.prompt_speech_tokens)
                self.captured[lane.request_id].append({
                    "tokens": np.asarray(q[n_prompt:], np.int64),
                    "done": bool(lane.done),
                    "feat": feat[j].float().cpu(),
                    "wav": np.asarray(wav[j], np.float32)})
            return wav

        b.flow_audio = flow_audio
        return hops

    # -- the output check -----------------------------------------------------
    def sample(self):
        """A seeded sample of the finished greedy requests, with the one
        that served the most tokens."""
        done = [rid for rid, caps in self.captured.items()
                if caps and caps[-1]["done"] and rid in self.final]
        if not done:
            return []
        k = self.mix["check_requests"]
        longest = max(done, key=lambda r: len(self.captured[r][-1]["tokens"]))
        rest = [r for r in done if r != longest]
        rng = traffic.rng_of(self.ctx.seed, 7)
        pick = list(rng.permutation(rest)[: k - 1]) if rest else []
        return [longest] + [int(r) for r in pick]

    def free_program(self):
        del self.b
        del self.pipe
        program.free(self.dev)

    @torch.no_grad()
    def check(self, lower: bool = False) -> dict:
        """The numbers compared, program against the plain reference; with
        `lower`, the control's (the reference one precision step down in
        the program's place) against the plain reference."""
        picks = self.sample()
        if not picks:
            return {"checked_requests": 0.0}
        dev = self.dev
        model, serving = self.model, self.serving
        states = self.states
        lm = checks.LMReference(model, states["lm"], serving, dev)
        lm_lo = checks.LMReference(model, states["lm"], serving, dev,
                                   lower=True) if lower else None
        fl = checks.flow_reference(model, states["flow"], dev)
        voc = checks.vocoder_reference(model, states["codec"], dev)
        fl_lo = voc_lo = None
        if lower:
            fl_lo = checks.lower_precision(
                checks.flow_reference(model, states["flow"], dev))
            voc_lo = checks.lower_precision(
                checks.vocoder_reference(model, states["codec"], dev))
        gap = lat = pcm = chunk = 0.0
        served_total = 0
        for rid in picks:
            r = self.reqs[rid]
            caps = self.captured[rid]
            served = caps[-1]["tokens"]
            served_total += len(served)
            ref_logits = lm.served_logits(r, served)
            gap = max(gap, checks.control_gap(
                ref_logits, lm_lo.served_logits(r, served)) if lower
                else checks.served_gap(ref_logits, served))
            del ref_logits
            wavs = []
            for cap in caps:
                toks = np.concatenate([np.asarray(r.prompt_speech_tokens,
                                                  np.int64), cap["tokens"]])
                n_fr = 2 * len(toks)
                ref = checks.flow_latents(fl, toks, r.prompt_feat,
                                          r.flow_emb, True, dev)
                got = cap["feat"][:n_fr].to(dev)
                if lower:
                    got = checks.flow_latents(fl_lo, toks, r.prompt_feat,
                                              r.flow_emb, True, dev)
                lat = max(lat, checks.rel_err(got, ref))
                # the codec on the hop's whole (padded) latents
                feat = cap["feat"].to(dev)[None]
                ref_wav = vocode(voc, feat)
                got_wav = torch.as_tensor(cap["wav"], device=dev)[None]
                if lower:
                    got_wav = vocode(voc_lo, feat)
                n_s = n_fr * SAMPLES_PER_FRAME
                pcm = max(pcm, checks.rel_err(got_wav[:, :n_s],
                                              ref_wav[:, :n_s]))
                wavs.append(got_wav[0].float().cpu().numpy() if lower
                            else cap["wav"])
            chunk = max(chunk, chunk_gap(self, r, caps, wavs, rid))
        return {"lm_gap": gap, "latent_rel": lat, "pcm_rel": pcm,
                "chunk_diff": chunk, "checked_requests": float(len(picks)),
                "checked_tokens": float(served_total)}


def vocode(voc, feat):
    """The DAC-VAE's decode of latents as the pipeline calls it; (B, S)."""
    return voc.decode(feat).reshape(feat.shape[0], -1)


def chunk_gap(run, r, caps, wavs, rid) -> float:
    """The largest difference between the chunks the program emitted for
    a request and the hop-cutting rule (the crossfaded cut of each hop's
    new audio) applied to each hop's PCM `wavs`."""
    mix = run.mix
    hop, look = mix["token_hop"], mix["lookahead"]
    overlap = mix["overlap_frames"] * SAMPLES_PER_FRAME
    window = np.hamming(2 * overlap)
    prompt_frames = r.prompt_feat.shape[0]
    emitted, prev_tail = 0, None
    want = []
    for cap, wav in zip(caps, wavs):
        n_tok = len(cap["tokens"])
        body = n_tok - (0 if cap["done"] else look)
        lo = (prompt_frames + emitted) * SAMPLES_PER_FRAME
        hi = (prompt_frames + body * 2) * SAMPLES_PER_FRAME
        if hi <= lo:
            continue
        w = np.asarray(wav[lo:hi], np.float32)
        if prev_tail is not None and len(w) >= overlap:
            w = w.copy()
            w[:overlap] = (w[:overlap] * window[:overlap]
                           + prev_tail * window[overlap:])
        if cap["done"]:
            want.append(w)
            break
        prev_tail = w[-overlap:]
        emitted = body * 2 - mix["overlap_frames"]
        want.append(w[: len(w) - overlap])
    got = run.chunks.get(rid, [])
    got = [c for c in got if len(c)]
    if len(got) != len(want) or any(len(a) != len(b)
                                    for a, b in zip(got, want)):
        return float("inf")
    return max((float(np.max(np.abs(a - b))) if len(a) else 0.0
                for a, b in zip(got, want)), default=0.0)


def plan_length(r) -> int:
    """A request's prompt plan: sos, speaker, prompt and request text,
    task, prompt speech."""
    return 3 + len(r.text_tokens) + len(r.prompt_text_tokens) \
        + len(r.prompt_speech_tokens)


def per_layer_record(run, flops: dict) -> dict:
    """What the stream cell's per-layer readers read."""
    rec = run.record
    rec["k1_calls"] = k1_calls(run)
    rec["useful_flops"] = useful_flops(run, flops)
    rec["useful_window_s"] = run.window[1] - run.window[0]
    rec["flops_per_unit"] = flops
    return rec


def k1_calls(run) -> list:
    """K1's calls in the traced hops: (rows' key lengths, heads, head
    dim, chunk) per call, the CFG batch doubling every row."""
    u = run.model["flow"]["unet"]
    per_pass = (2 * len(u["channels"]) + u["num_mid_blocks"]) * u["n_blocks"]
    n_calls = per_pass * run.model["flow"]["n_timesteps"]
    out = []
    for h in run.record["hops"]:
        if h["traced"]:
            kv = [2 * n for n in h["lens"]] * 2
            out.append((kv, u["num_heads"], u["attention_head_dim"],
                        u["static_chunk_size"], n_calls))
    return out


def useful_flops(run, flops: dict) -> float:
    """The window's useful model FLOPs: each token the LM generated (at
    its context length) and each prompt plan prefilled, once; each
    emitted frame once through the flow's encoder and its 10 CFG Euler
    steps (two UNet passes each, attention at the frame's chunk-causal
    key count) and once through the codec."""
    model = run.model
    q = model["lm"]["qwen"]
    vocab = model["lm"]["speech_token_size"] + 3
    w0, w1 = run.window
    total = 0.0
    for t, ctx_len in run.record["emitted"]:
        if w0 <= t < w1:
            total += roofline.lm_token_flops(q, vocab, ctx_len)
    for rid, t in run.record["admitted"].items():
        if w0 <= t < w1:
            total += sum(roofline.lm_token_flops(q, vocab, p)
                         for p in range(plan_length(run.reqs[rid])))
    u = model["flow"]["unet"]
    per_pass = (2 * len(u["channels"]) + u["num_mid_blocks"]) * u["n_blocks"]
    steps = model["flow"]["n_timesteps"]
    hd = u["num_heads"] * u["attention_head_dim"]
    chunk = u["static_chunk_size"]
    for t, frames_from, frames in run.record["frames"]:
        if not (w0 <= t < w1):
            continue
        for p in range(frames_from, frames_from + frames):
            keys = (p // chunk + 1) * chunk  # the chunk-causal key count
            total += (flops["encoder"] / 2 + flops["vocoder"]
                      + 2 * steps * (flops["unet"] + per_pass * 4 * hd * keys))
    return total


def measure(ctx) -> dict:
    """The cell's run: the window, then the output check on the plain
    reference once the program is freed; in a traced run the per-layer
    record."""
    run = StreamRun(ctx)
    e2e = run.run()
    return finish(ctx, run, e2e)


def finish(ctx, run, e2e) -> dict:
    from speechbench.run import CACHE
    rec = run.record
    ctx.notes.update(requests=rec["n_requests"], streams=rec["n_rtf"],
                     lanes_busy=_mean([n for _, n in rec["ticks"]]))
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop()
    run.free_program()
    t_check = time.perf_counter()
    numbers = run.check()
    ctx.notes.update(window_end_s=t_check - ctx.t0,
                     check_s=time.perf_counter() - t_check,
                     **{k: v for k, v in numbers.items()
                        if k.startswith("checked")})
    ok, table = checks.verdict(numbers, checks.load_limits(ctx.workload))
    record = {}
    if ctx.trace:
        flops = roofline.per_frame_flops(
            run.model, CACHE / f"flops-{ctx.cell['config']}.json")
        ctx.notes["flops_per_unit"] = flops
        record = per_layer_record(run, flops)
        record["spans"] = {n: ctx.recorder.in_window(n)
                           for n in list(ctx.recorder.spans)}
        record["trace"] = ctx.tracer.summary()
    return {"e2e": e2e, "correct": ok, "checks": table, "record": record}


def _mean(v):
    return sum(v) / len(v) if v else 0.0


Run = StreamRun
