"""Stage-1 LM training, as cli/train.py runs it by default: the float LM
in float32, AdamW with the config's schedule and clip, frame-budget
batches of synthetic utterances through the port's own data stages
(`shuffle`, `sort_by_len`, `dynamic_batch`, `padding_llm`) and its
train step (`steps.make_lm_train_step`), every attention through K2.

Set-up builds one train state and drives it from the seed through its
first `checked_steps` steps, through the window's own feed and call,
recording each step's loss, the first gradient as the optimizer took it
(Adam's first moment after one step, over 1 - b1) and each leaf's change
after the checked steps; then the window trains that same state on. Once
the window has closed and the program's state is freed, the plain
reference (speechbench/reference: the LM, its loss, AdamW) follows the
checked steps from the same weights on the same batches, in row blocks
whose gradients add up to the batch's, and the numbers compared are:
the worst step's loss gap, and for the first gradient and the change,
the worst leaf's gap between the two norms over the larger of the
reference leaf's norm and the median leaf's. Leaves whose reference
gradient is under a thousandth of the median leaf's (nought to rounding:
Adam moves them by round-off alone) are left out of the change.
"""
from __future__ import annotations

import itertools
import random
import time

import numpy as np
import torch

from speechbench import checks, program, roofline, traffic, weights
from speechbench.reference import adamw as ref_adamw
from speechbench.reference import llm as ref_llm
from speechbench.reference import models as ref_models

TRUE_KEYS = ("src_type", "tok_id", "target", "seq_len", "reference_mel",
             "reference_mel_len")


def utterances(mix: dict, seed: int, lm_cfg) -> "itertools.chain":
    """An endless feed of synthetic samples: the mix's pool, repeated."""
    pool = traffic.train_utterances(
        mix, seed, mix["pool"], text_vocab=lm_cfg.qwen.vocab_size,
        speech_vocab=lm_cfg.speech_token_size)
    return itertools.chain.from_iterable(itertools.repeat(pool))


def batches(mix: dict, seed: int, lm_cfg, train: dict):
    """The port's LM data stages over the feed (Python's `random`, which
    they draw from, seeded from the seed)."""
    from minimax_speech_torch.data import pipeline as dp
    random.seed(int(seed))
    it = utterances(mix, seed, lm_cfg)
    it = dp.shuffle(it, mix["shuffle"])
    it = dp.sort_by_len(it, mix["sort"])
    it = dp.dynamic_batch(it, train["max_frames_in_batch"])
    return dp.padding_llm(it, mix_ratio=tuple(lm_cfg.mix_ratio),
                          bistream_prob=train["bistream_prob"],
                          eos=lm_cfg.eos_token, fill=lm_cfg.fill_token)


class TrainRun:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.traffic
        self.model_cfg = ctx.config["model"]
        self.train = ctx.config["train"]
        self.dev = ctx.device

    def build(self):
        from minimax_speech_torch.config import build_tts_config
        from minimax_speech_torch.models import llm as llm_mod
        from minimax_speech_torch.train import schedule, steps
        data = program.tts_data(self.model_cfg)
        q = data["lm"]["qwen"]
        q["remat"] = bool(self.train["remat"])
        cfg = build_tts_config(data).lm
        self.lm_cfg = cfg
        with torch.device(self.dev):
            model = llm_mod.SpeechLM(cfg)
        self.state0 = weights.make_state(model, int(self.ctx.seed) * 4 + 3,
                                         self.dev)
        model.load_state_dict(self.state0)
        model.train()
        t = self.train
        tx = schedule.make_optimizer(
            lr=t["lr"], warmup_steps=t["warmup_steps"],
            scheduler=t["scheduler"], grad_clip=t["grad_clip"],
            accum_steps=t["accum_grad"])
        self.model = model
        self.state = steps.make_train_state(model, tx)
        self.step_fn = steps.make_lm_train_step(model, device=self.dev)
        self.feed = batches(self.mix, self.ctx.seed, cfg, t)

    def one(self, host_batch=None):
        """One step through the window's feed and call; returns the host
        batch and the step's metrics (tensors)."""
        hb = next(self.feed) if host_batch is None else host_batch
        b = {k: torch.as_tensor(hb[k]).to(self.dev) for k in TRUE_KEYS}
        self.state, metrics = self.step_fn(self.state, b)
        return hb, metrics

    def run(self):
        ctx, mix = self.ctx, self.mix
        self.build()
        names = {id(p): n for n, p in self.model.named_parameters()}
        params = self.state.params()
        self.leaf_names = [names[id(p)] for p in params]
        p0 = [p.detach().clone() for p in params]
        self.checked, self.losses = [], []
        for k in range(mix["checked_steps"]):
            hb, m = self.one()
            self.checked.append(hb)
            self.losses.append(float(m["loss"]))
            if k == 0:  # the first gradient as Adam took it: mu / (1 - b1)
                from minimax_speech_torch.train.schedule import B1
                self.grad_norms = [float(torch.linalg.vector_norm(
                    mu.double() / (1.0 - B1))) for mu in self.state.opt_state.mu]
        self.change_norms = [float(torch.linalg.vector_norm(
            (p.detach() - q).double())) for p, q in zip(params, p0)]
        del p0
        program.sync(self.dev)

        steps_rec = []
        t0 = time.perf_counter()
        ctx.window_start = t0
        t_trace = None
        while True:
            now = time.perf_counter() - t0
            if now >= ctx.seconds:
                break
            if ctx.tracer is not None and t_trace is None \
                    and now >= ctx.seconds - mix["trace_s"]:
                program.sync(self.dev)
                t_trace = time.perf_counter() - t0
                ctx.tracer.start()
            hb, _ = self.one()
            steps_rec.append({"seq_len": [int(n) for n in hb["seq_len"]],
                              "shape": list(hb["src_type"].shape),
                              "traced": t_trace is not None})
        program.sync(self.dev)
        window = time.perf_counter() - t0
        if ctx.tracer is not None and ctx.tracer.active:
            ctx.tracer.stop()
        ctx.memory_peak_bytes = program.memory_peak(self.dev)
        self.steps = steps_rec
        self.window_s = window
        self.untraced_s = t_trace if t_trace is not None else window
        ctx.attempted = len(steps_rec)
        ctx.failed = 0
        tokens = sum(sum(s["seq_len"]) for s in steps_rec)
        return {"train_tokens_per_s": tokens / window}

    def free_program(self):
        del self.state, self.step_fn, self.model, self.feed
        program.free(self.dev)

    # -- the output check -----------------------------------------------------
    def check(self, lower: bool = False, half: bool = False) -> dict:
        """The numbers compared, the program's against the plain
        reference's; with `lower`, the control's (the reference with TF32
        on, one step below float32 with TF32 off) against it; with
        `half`, the fault of a step that leaves out half of each batch
        and takes the mean over the rest, planted in the reference."""
        ref = self.reference_run(False)
        got = self.reference_run(lower, half) if (lower or half) else {
            "losses": self.losses, "grad_norms": dict(zip(
                self.leaf_names, self.grad_norms)),
            "change_norms": dict(zip(self.leaf_names, self.change_norms))}
        return compare(ref, got)

    def reference_run(self, tf32: bool, half: bool = False) -> dict:
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            batches = [{k: v[: (len(v) + 1) // 2] for k, v in hb.items()}
                       for hb in self.checked] if half else self.checked
            return reference_steps(self.model_cfg, self.train, self.state0,
                                   batches, self.dev,
                                   self.mix["block_tokens"])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def reference_steps(model_cfg, train, state0, host_batches, device,
                    block_tokens: int) -> dict:
    """The plain LM and AdamW through the checked steps from state0:
    each step's loss, the first clipped gradient's norm and each leaf's
    change after the last step, by leaf name."""
    cfg = ref_models.build_lm_config(model_cfg)
    model = ref_models.on(device, lambda: ref_llm.SpeechLM(cfg))
    model.load_state_dict(state0)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    opt = ref_adamw.AdamW(params, train["lr"], train["warmup_steps"],
                          train["grad_clip"])
    losses, grad_norms = [], None
    for k, hb in enumerate(host_batches):
        loss, grads = blocked_grads(model, params, hb, device, block_tokens)
        losses.append(loss)
        clipped = opt.step(grads)
        if k == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(g.double()))
                          for n, g in zip(names, clipped)}
        del grads, clipped
    change = {n: float(torch.linalg.vector_norm((p.detach() - q).double()))
              for n, p, q in zip(names, params, start)}
    del model, params, start, opt
    program.free(device)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def blocked_grads(model, params, hb, device, block_tokens: int):
    """The batch's loss (label-smoothed CE over its valid targets) and its
    gradients, summed over row blocks of about block_tokens padded
    tokens: each block's loss sum over the batch's target count."""
    n_valid = int(np.sum(hb["target"] != ref_llm.IGNORE_ID))
    b, length = hb["src_type"].shape
    rows = max(1, block_tokens // length)
    grads = [torch.zeros_like(p) for p in params]
    total = 0.0
    for r0 in range(0, b, rows):
        sl = slice(r0, r0 + rows)
        t = {k: torch.as_tensor(hb[k][sl]).to(device) for k in TRUE_KEYS}
        n_blk = int((t["target"] != ref_llm.IGNORE_ID).sum())
        if n_blk == 0:
            continue
        mask = (torch.arange(t["reference_mel"].shape[1], device=device)[None]
                < t["reference_mel_len"][:, None])
        spk = model.embed_speaker(t["reference_mel"], mask)
        loss = model(t["src_type"].long(), t["tok_id"].long(),
                     t["target"].long(), t["seq_len"], spk) * (n_blk / n_valid)
        g = torch.autograd.grad(loss, params, allow_unused=True)
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc.add_(gi)
        total += float(loss.detach())
    return total, grads


def compare(ref: dict, got: dict) -> dict:
    """loss_gap: the worst step's |loss - ref| / |ref|; grad_gap and
    change_gap: the worst leaf's |norm - ref norm| over the larger of the
    ref leaf's norm and the median leaf's."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(got["losses"], ref["losses"]))
    rg = ref["grad_norms"]
    med_g = float(np.median(list(rg.values())))
    grad_gap = max(abs(got["grad_norms"][n] - v) / max(v, med_g)
                   for n, v in rg.items())
    moved = [n for n, v in rg.items() if v >= 1e-3 * med_g]
    rc = ref["change_norms"]
    med_c = float(np.median([rc[n] for n in moved]))
    change_gap = max(abs(got["change_norms"][n] - rc[n]) / max(rc[n], med_c)
                     for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "checked_steps": float(len(ref["losses"])),
            "leaves_left_out": float(len(rg) - len(moved))}


def k2_calls(run) -> list:
    q = run.model_cfg["lm"]["qwen"]
    out = []
    for s in run.steps:
        if s["traced"]:
            for backward in (False, True):
                out.append((s["seq_len"], q["n_heads"], q["head_dim"], 0,
                            q["n_layers"], True, backward))
    return out


def useful_flops(run) -> float:
    """6 x the non-embedding parameters per true token, plus the causal
    attention's forward and backward (12 d per visible pair per head per
    layer), over the untraced steps."""
    q = run.model_cfg["lm"]["qwen"]
    vocab = run.model_cfg["lm"]["speech_token_size"] + 3
    n = roofline.lm_nonembedding_params(q, vocab)
    total = 0.0
    for s in run.steps:
        if s["traced"]:
            continue
        total += 6.0 * n * sum(s["seq_len"])
        pairs = sum(roofline.visible_pairs(x, causal=True)
                    for x in s["seq_len"])
        total += 12.0 * q["head_dim"] * q["n_heads"] * q["n_layers"] * pairs
    return total


def measure(ctx) -> dict:
    run = TrainRun(ctx)
    e2e = run.run()
    run.free_program()
    t_check = time.perf_counter()
    numbers = run.check()
    ctx.notes.update(window_end_s=t_check - ctx.t0,
                     check_s=time.perf_counter() - t_check,
                     steps=len(run.steps), losses=run.losses,
                     leaves_left_out=numbers.get("leaves_left_out"))
    ok, table = checks.verdict(numbers, checks.load_limits(ctx.workload))
    record = {}
    if ctx.trace:
        record = {"kind": "train", "steps": run.steps,
                  "k2_calls": k2_calls(run),
                  "useful_flops": useful_flops(run),
                  "useful_window_s": run.untraced_s,
                  "trace": ctx.tracer.summary()}
    return {"e2e": e2e, "correct": ok, "checks": table, "record": record}


Run = TrainRun
