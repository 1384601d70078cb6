"""Training CLI: `python -m minimax_speech_torch.cli.train --model {llm,flow}`.

Port of the single-device path of minimax_speech_tpu/cli/train.py for
the Stage-1 LM (`--model llm`; `--dpo` fine-tunes it against a frozen
reference policy, `--ref_ckpt` or the starting weights, on
<stem>_fsq_reject sidecars) and the Stage-2 flow (`--model flow`, with
`--latent_stats`): config + overrides, the data pipeline (the flow
chain ends in padding_flow), the model from a seed or an `--init_ckpt`
.npz (the JAX package's format), AdamW + clip, the metrics log,
checkpoints with resume, the epoch loop, `--cv_data`, and `--export_npz`
(a .npz the JAX package loads). The flow step takes its random draws
from a generator seeded with (1986, global step) and cv batch i from
seed i (train/executor.py). Under grad the flow UNet attends through K2,
without grad (the cv loss) through K1 (models/decoder_unet.py). Runs on
`--device` (default cuda; raises without a GPU).

Epoch resume departs from the JAX CLI on purpose, fixing two flaws:
  * the run key hashes the train list's content, --model, the latent
    stats and the --dpo, --bf16, --init_ckpt and --ref_ckpt flags besides
    the train config and max_epoch, so a run on other data or with other
    flags starts at epoch 0;
  * the rollback is counted in epochs: epoch_state.json keeps the step
    at which each completed epoch ended, and a resume from a checkpoint
    at step S restarts at the first epoch that ended after S.

As in the JAX CLI, --bf16 does nothing under --dpo (the DPO step has no
bf16 route); the CLI says so. Per-layer remat of the LM:
--override model.lm.qwen.remat=true (model.lm.qwen.remat_policy none or
dots).

Not ported yet (each raises NotImplementedError; ROADMAP.md, queue 1):
--distributed, --tp/--dp > 1 (multi-GPU), and a tokenizer path.
"""
from __future__ import annotations

import argparse
import bisect
import hashlib
import json
from pathlib import Path

import numpy as np

INIT_SEED = 1986
_NOT_PORTED = ("is not ported yet (ROADMAP.md, queue 1, item 3d: "
               "multi-GPU)")
PLAN_KEYS = ("src_type", "tok_id", "target", "seq_len")
BATCH_KEYS = {"llm": (*PLAN_KEYS, "reference_mel", "reference_mel_len"),
              "dpo": (*PLAN_KEYS, *(k + "_rej" for k in PLAN_KEYS),
                      "reference_mel", "reference_mel_len"),
              "flow": ("token", "token_len", "feat", "feat_len",
                       "reference_mel", "reference_mel_len")}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["llm", "flow"], required=True)
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--override", action="append", default=[],
                   help="dotted config overrides, e.g. train.lr=1e-5")
    p.add_argument("--train_data", type=str, required=True,
                   help="file with one wav path per line")
    p.add_argument("--cv_data", type=str, default=None)
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--init_ckpt", type=str, default=None,
                   help=".npz params to start from (the JAX package's "
                        "format)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 forward/backward (fp32 optimizer)")
    p.add_argument("--dpo", action="store_true",
                   help="DPO fine-tuning (llm only): needs <stem>_fsq_reject "
                        "sidecars; the frozen reference policy is "
                        "--ref_ckpt (default: the starting weights)")
    p.add_argument("--ref_ckpt", type=str, default=None,
                   help=".npz of the DPO reference policy (the JAX "
                        "package's format)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead in a background thread "
                        "(0 disables)")
    p.add_argument("--export_npz", type=str, default=None,
                   help="also write the final params as a .npz in the "
                        "JAX package's format")
    p.add_argument("--latent_stats", type=str, default=None,
                   help="latent_stats.json ({mean, std}; flow only): the "
                        "flow solves in standardized latent space")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_ported(args):
    if args.dpo and args.model != "llm":
        raise ValueError("--dpo fine-tunes the LM: it takes --model llm")
    if args.distributed:
        raise NotImplementedError(f"--distributed {_NOT_PORTED}")
    if args.tp != 1 or (args.dp or 1) != 1:
        raise NotImplementedError(f"--tp/--dp > 1 {_NOT_PORTED}")


def build_stages(cfg_train, tokenizer, model_kind: str = "llm",
                 dpo: bool = False):
    """The chain: open, tokenize, filter, resample, reference mel,
    shuffle, sort, frame-budget batches, then the LM's plan padding (with
    the rejected plans under dpo) or the flow's padding."""
    from minimax_speech_torch.data import pipeline as dp
    if model_kind == "flow":
        pad = dp.padding_flow
    else:
        def pad(it):
            return dp.padding_llm(
                it, bistream_prob=cfg_train.get("bistream_prob", 0.5),
                dpo=dpo)
    return [
        dp.individual_file_opener,
        lambda it: dp.tokenize(it, tokenizer),
        dp.filter_lengths,
        dp.resample,
        dp.extract_reference_mel,
        lambda it: dp.shuffle(it, 1000),
        lambda it: dp.sort_by_len(it, 500),
        lambda it: dp.dynamic_batch(
            it, cfg_train.get("max_frames_in_batch", 25000)),
        pad,
    ]


def run_key(tcfg: dict, max_epoch: int, train_list: str, args,
            latent_stats=None) -> str:
    """Identity of a run for epoch resume: the train config, the epoch
    budget, the train list's content, the model, the latent stats and the
    flags that change what is trained."""
    data = hashlib.sha256(Path(train_list).read_bytes()).hexdigest()
    return hashlib.sha256(json.dumps(
        [tcfg, max_epoch, data, args.model, latent_stats, bool(args.dpo),
         bool(args.bf16), args.init_ckpt, args.ref_ckpt], sort_keys=True,
        default=str).encode()).hexdigest()[:16]


def resume_epoch(ep_path: Path, key: str, restored_step: int) -> int:
    """The first epoch to train: the count of completed epochs of this
    run whose last step the restored checkpoint covers."""
    if not restored_step or not ep_path.exists():
        return 0
    try:
        es = json.loads(ep_path.read_text())
        if es.get("key") != key:
            return 0
        return bisect.bisect_right([int(s) for s in es["end_steps"]],
                                   restored_step)
    except (ValueError, KeyError, TypeError):  # partial write: start over
        return 0


def write_epoch_state(ep_path: Path, key: str, end_steps: list[int]):
    tmp = ep_path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps({"key": key, "epoch": len(end_steps) - 1,
                               "end_steps": end_steps}))
    tmp.replace(ep_path)


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)

    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.data import pipeline as dp
    from minimax_speech_torch.infer.frontend import get_tokenizer
    from minimax_speech_torch.models import flow as flow_mod
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.train.checkpoint import CheckpointManager
    from minimax_speech_torch.train.executor import Executor
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.logging import MetricsLogger

    device = resolve_device(args.device)
    data = cfg_lib.apply_overrides(cfg_lib.load_yaml(args.config),
                                   args.override)
    stats = None
    if args.latent_stats:
        stats = json.loads(Path(args.latent_stats).read_text())
        data = cfg_lib.apply_overrides(data, [
            "model.flow.latent_mean=" + json.dumps(stats["mean"]),
            "model.flow.latent_std=" + json.dumps(stats["std"])])
    tts_cfg = cfg_lib.build_tts_config(data.get("model", {}))
    tcfg = data.get("train", {})
    tokenizer = get_tokenizer(args.tokenizer_path)

    flow = args.model == "flow"
    model = flow_mod.FlowModel(tts_cfg.flow) if flow \
        else llm_mod.SpeechLM(tts_cfg.lm)
    if args.init_ckpt:
        params_io.load_flax_params(model, params_io.load_params(
            args.init_ckpt))
    else:
        params_io.init_params(model,
                              torch.Generator().manual_seed(INIT_SEED))
    model.to(device)
    if args.dpo:
        from minimax_speech_torch.train import gan_steps
        ref = llm_mod.SpeechLM(tts_cfg.lm)
        if args.ref_ckpt:
            params_io.load_flax_params(ref, params_io.load_params(
                args.ref_ckpt))
        else:  # the starting weights, before any resume
            ref.load_state_dict(model.state_dict())
        if args.bf16:
            print("--bf16 is ignored under --dpo: the DPO step runs in "
                  "float32, as the JAX package's")
        step_fn = gan_steps.make_dpo_step(model, ref.to(device),
                                          device=device)
    else:
        make_step = steps.make_flow_train_step if flow \
            else steps.make_lm_train_step
        step_fn = make_step(model, bf16=args.bf16, device=device)
    tx = schedule.make_optimizer(
        lr=tcfg.get("lr", 5e-5), warmup_steps=tcfg.get("warmup_steps", 500),
        scheduler=tcfg.get("scheduler", "constantlr"),
        grad_clip=tcfg.get("grad_clip", 1.0),
        accum_steps=tcfg.get("accum_grad", 1))
    state = steps.make_train_state(model, tx)

    logger = MetricsLogger(args.model_dir, name=args.model,
                           log_interval=tcfg.get("log_interval", 5))
    ckpt = CheckpointManager(str(Path(args.model_dir) / "ckpt"))
    state, start_step = ckpt.restore(state)
    if start_step:
        print(f"resumed from step {start_step}")

    keys = BATCH_KEYS["dpo" if args.dpo else args.model]

    def put(batch):
        return {k: torch.as_tensor(np.asarray(v)).to(device)
                for k, v in batch.items() if k in keys}

    def draws(batch, generator):
        return flow_mod.make_flow_draws(
            tts_cfg.flow, *batch["feat"].shape[:2], generator)

    ex = Executor(step_fn, state, logger, ckpt,
                  save_per_step=tcfg.get("save_per_step", 2000),
                  put_batch=put, device=device,
                  make_draws=draws if flow else None)

    def data_list(path, **kw):
        return dp.DataList([{"src": line.strip()} for line in
                            Path(path).read_text().splitlines()
                            if line.strip()], **kw)

    source = data_list(args.train_data)
    stages = build_stages(tcfg, tokenizer, args.model, dpo=args.dpo)
    cv_source = data_list(args.cv_data, shuffle=False) if args.cv_data \
        else None
    if flow:
        flow_loss = steps.make_flow_loss_fn(model, bf16=args.bf16)

        def cv_loss(state, batch, draws):
            with torch.no_grad():
                return {"loss": flow_loss(batch, draws)}
    else:
        lm_loss = steps.make_lm_loss_fn(model, bf16=args.bf16)

        def cv_loss(state, batch):
            with torch.no_grad():
                loss, acc = lm_loss(batch)
            return {"loss": loss, "acc": acc}

    max_epoch = args.max_epoch or tcfg.get("max_epoch", 2000)
    key = run_key(tcfg, max_epoch, args.train_data, args, stats)
    ep_path = Path(args.model_dir) / "epoch_state.json"
    start_epoch = resume_epoch(ep_path, key, start_step)
    end_steps = []
    if start_epoch:
        end_steps = json.loads(ep_path.read_text())["end_steps"][:start_epoch]
        print(f"resuming at epoch {start_epoch}/{max_epoch}")
    for epoch in range(start_epoch, max_epoch):
        source.set_epoch(epoch)
        ex.train_one_epoch(dp.prefetch(dp.build_dataset(source, stages),
                                       depth=args.prefetch))
        logger.log(ex.step, {"epoch": epoch}, force=True)
        end_steps.append(ex.step)
        write_epoch_state(ep_path, key, end_steps)
        if cv_source is not None:
            ex.cv(dp.build_dataset(cv_source, stages), cv_loss)
    ckpt.save(ex.step, ex.state)
    if args.export_npz:
        params_io.save_params(args.export_npz, model)
        print(f"exported params to {args.export_npz}")
    return ex.state


if __name__ == "__main__":
    main()
