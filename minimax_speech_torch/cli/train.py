"""Training CLI: `python -m minimax_speech_torch.cli.train --model {llm,flow}`.

Port of minimax_speech_tpu/cli/train.py for the Stage-1 LM (`--model llm`; `--dpo` fine-tunes it against a frozen
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

Multi-GPU (--distributed, one process per GPU, as cli/launch.py starts
them; the JAX package runs one process over several devices instead):
each rank joins the world at --coordinator as --process_id of
--num_processes (NCCL on cuda, gloo on the CPU, or --backend) and takes
its place on a --dp x --tp mesh (dp defaults to world // tp): the LM,
DPO and flow steps split the batch over dp and the model over tp, with
ZeRO-2 optimizer state (train/steps.py, parallel/). With more than one rank the data
takes the JAX multi-host branch: fixed batch size and pads
(train.batch_size, pad_seq or pad_tokens, pad_ref), the train list
partitioned by dp rank and read by each dp rank's first tp rank (its tp
peers receive its batches), every epoch cut to the shortest rank's count
(uneven_join_batches); rank 0 logs and writes the epoch state, every
rank enters the checkpoint's collectives, and --export_npz is gathered
to rank 0. cv batches are whole on every rank.

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

--tokenizer_path takes a .tiktoken asset (the Whisper tokenizer) or a
Hugging Face Qwen2 tokenizer directory (infer/qwen_tokenizer.py).
--dp/--tp > 1 without --distributed raise: one process drives one GPU
(start the ranks with python -m minimax_speech_torch.cli.launch).
"""
from __future__ import annotations

import argparse
import bisect
import hashlib
import json
from pathlib import Path

import numpy as np

INIT_SEED = 1986
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
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel extent (default: world size // tp)")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--distributed", action="store_true",
                   help="join a world of --num_processes ranks at "
                        "--coordinator as rank --process_id (as "
                        "cli/launch.py starts them)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0's rendezvous")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", type=str, default=None,
                   help="torch.distributed backend (default nccl on cuda, "
                        "gloo on the CPU; gloo lets ranks share one GPU)")
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
    if not args.distributed and (args.tp != 1 or (args.dp or 1) != 1):
        raise ValueError(
            "--dp/--tp > 1 need one process per GPU: start the ranks with "
            "python -m minimax_speech_torch.cli.launch --nproc N -- ...")
    if args.distributed and None in (args.coordinator, args.num_processes,
                                     args.process_id):
        raise ValueError("--distributed needs --coordinator, "
                         "--num_processes and --process_id")


def build_stages(cfg_train, tokenizer, model_kind: str = "llm",
                 dpo: bool = False, static_shapes: bool = False):
    """The chain: open, tokenize, filter, resample, reference mel,
    shuffle, sort, frame-budget batches, then the LM's plan padding (with
    the rejected plans under dpo) or the flow's padding. static_shapes
    (more than one rank): every rank runs the same shapes each step, so
    samples that cannot fit are dropped before fixed-size batches
    (train.batch_size, drop_last) padded to fixed lengths (train.pad_seq
    for the LM's plans, train.pad_tokens for the flow's tokens,
    train.pad_ref for the reference mels)."""
    from minimax_speech_torch.data import pipeline as dp
    lm_pad_to = cfg_train.get("pad_seq", 1024) if static_shapes else None
    pad_ref = cfg_train.get("pad_ref", 224) if static_shapes else None
    if model_kind == "flow":
        pad_tokens = cfg_train.get("pad_tokens", 512) if static_shapes \
            else None

        def pad(it):
            return dp.padding_flow(it, pad_tokens=pad_tokens,
                                   pad_ref=pad_ref)
    else:
        def pad(it):
            return dp.padding_llm(
                it, bistream_prob=cfg_train.get("bistream_prob", 0.5),
                dpo=dpo, pad_to=lm_pad_to, pad_ref=pad_ref)
    if static_shapes:
        max_len = lm_pad_to if model_kind == "llm" else pad_tokens
        batching = [
            lambda it: dp.filter_static_shapes(it, model_kind, max_len,
                                               dpo=dpo),
            lambda it: dp.static_batch(it, cfg_train.get("batch_size", 8),
                                       drop_last=True)]
    else:
        batching = [lambda it: dp.dynamic_batch(
            it, cfg_train.get("max_frames_in_batch", 25000))]
    return [
        dp.individual_file_opener,
        lambda it: dp.tokenize(it, tokenizer),
        dp.filter_lengths,
        dp.resample,
        dp.extract_reference_mel,
        lambda it: dp.shuffle(it, 1000),
        lambda it: dp.sort_by_len(it, 500),
        *batching,
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
    from minimax_speech_torch.parallel import mesh as mesh_lib
    from minimax_speech_torch.parallel.layers import shard_module
    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.train.checkpoint import CheckpointManager
    from minimax_speech_torch.train.executor import Executor
    from minimax_speech_torch.utils import distributed, params_io
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.logging import MetricsLogger

    mesh = None
    if args.distributed:
        device = distributed.initialize(args.coordinator, args.num_processes,
                                        args.process_id, args.backend,
                                        args.device)
        mesh = mesh_lib.make_mesh(args.dp, args.tp)
    else:
        device = resolve_device(args.device)
    multi = mesh is not None and mesh.size > 1
    main_rank = mesh is None or mesh.is_main
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
        if args.bf16 and main_rank:
            print("--bf16 is ignored under --dpo: the DPO step runs in "
                  "float32, as the JAX package's")
        ref.to(device)
        if mesh is not None:  # sharded as the policy is
            shard_module(ref, mesh, "lm")
        step_fn = gan_steps.make_dpo_step(model, ref, device=device)
    else:
        make_step = steps.make_flow_train_step if flow \
            else steps.make_lm_train_step
        step_fn = make_step(model, bf16=args.bf16, device=device)
    tx = schedule.make_optimizer(
        lr=tcfg.get("lr", 5e-5), warmup_steps=tcfg.get("warmup_steps", 500),
        scheduler=tcfg.get("scheduler", "constantlr"),
        grad_clip=tcfg.get("grad_clip", 1.0),
        accum_steps=tcfg.get("accum_grad", 1))
    state = steps.make_train_state(model, tx, mesh, kind=args.model)

    logger = MetricsLogger(args.model_dir, name=args.model,
                           log_interval=tcfg.get("log_interval", 5))
    ckpt = CheckpointManager(str(Path(args.model_dir) / "ckpt"))
    state, start_step = ckpt.restore(state)
    if start_step and main_rank:
        print(f"resumed from step {start_step}")

    keys = BATCH_KEYS["dpo" if args.dpo else args.model]

    def put(batch):
        return {k: torch.as_tensor(np.asarray(v)).to(device)
                for k, v in batch.items() if k in keys}

    def draws(batch, generator, rows=None):
        b, t = batch["feat"].shape[:2]
        return flow_mod.make_flow_draws(tts_cfg.flow, rows or b, t,
                                        generator)

    ex = Executor(step_fn, state, logger, ckpt,
                  save_per_step=tcfg.get("save_per_step", 2000),
                  put_batch=put, device=device,
                  make_draws=draws if flow else None)

    def data_list(path, **kw):
        return dp.DataList([{"src": line.strip()} for line in
                            Path(path).read_text().splitlines()
                            if line.strip()], **kw)

    # each dp rank reads its share of the list, through its first tp rank
    reader = mesh is None or mesh.tp_rank == 0
    source = data_list(args.train_data,
                       process_index=0 if mesh is None else mesh.dp_rank,
                       process_count=1 if mesh is None else mesh.dp)
    stages = build_stages(tcfg, tokenizer, args.model, dpo=args.dpo,
                          static_shapes=multi)
    cv_source = data_list(args.cv_data, shuffle=False, partition=False) \
        if args.cv_data else None

    def shared(batches):
        """Under tp, the batches of this dp rank's first tp rank."""
        return distributed.tp_shared_batches(batches if reader else None,
                                             mesh)

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
        if main_rank:
            print(f"resuming at epoch {start_epoch}/{max_epoch}")
    for epoch in range(start_epoch, max_epoch):
        source.set_epoch(epoch)
        batches = shared(dp.prefetch(dp.build_dataset(source, stages),
                                     depth=args.prefetch))
        if multi:
            batches = distributed.uneven_join_batches(batches)
        ex.train_one_epoch(batches)
        end_steps.append(ex.step)
        if main_rank:
            logger.log(ex.step, {"epoch": epoch}, force=True)
            write_epoch_state(ep_path, key, end_steps)
        if cv_source is not None:
            ex.cv(shared(dp.build_dataset(cv_source, stages)), cv_loss)
    ckpt.save(ex.step, ex.state)
    if args.export_npz:
        export_params(args.export_npz, ex.state)
        if main_rank:
            print(f"exported params to {args.export_npz}")
    if args.distributed:
        distributed.sync_hosts()
        distributed.shutdown()
    return ex.state


def export_params(path: str, state):
    """The trained weights as a .npz in the JAX package's format; under a
    mesh gathered whole and written by rank 0."""
    from minimax_speech_torch.parallel.collectives import full_tensors
    from minimax_speech_torch.utils import params_io
    if state.mesh is None:
        params_io.save_params(path, state.module)
        return
    whole = full_tensors([p.detach() for p in state.params()],
                         state.layouts, state.mesh)
    if state.mesh.is_main:
        params_io.save_params(path, state.module, whole)


if __name__ == "__main__":
    main()
