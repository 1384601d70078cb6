"""The LM and flow training steps: forward, backward, clip, update,
metrics.

Port of minimax_speech_tpu/train/steps.py. PyTorch runs eagerly, so a
step is a plain function that updates the state in place; the metrics
stay on the device until a caller reads them. The flow step takes its
random draws (models/flow.FlowDraws) as an argument, where the JAX step
takes a key.

bf16=True runs the forward and backward through bfloat16 copies of the
float32 parameters (torch.func.functional_call), with the batch's float
tensors cast too, so the gradients land on the float32 masters, as the
JAX package's cast of the parameter tree does. Norms and softmax still
accumulate in float32 inside the modules.

Under a dp x tp mesh (make_train_state(..., mesh, kind)), one process per
rank: the module holds this rank's tensor-parallel slices, the batch is
this dp rank's share of the global batch, and each loss is this rank's
share of the global batch's (its numerator over the global denominator,
utils/losses.py), so the gradients all-reduced (summed) over dp are the
global batch's. The replicated biases of column-parallel layers have
their gradients summed over tp first. The optimizer keeps ZeRO-2 slices
(train/schedule.py); the metrics are the global batch's, the norms the
whole model's. The all-reduce stands where ZeRO-2 proper reduce-scatters:
gloo takes no reduce-scatter of CUDA tensors, and one card's two-rank
runs go through gloo.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from minimax_speech_torch.parallel.collectives import all_reduce_buckets
from minimax_speech_torch.parallel.layers import shard_module
from minimax_speech_torch.parallel.mesh import Mesh
from minimax_speech_torch.train.schedule import (OptState, Optimizer,
                                                 global_norm, global_norms)
from minimax_speech_torch.utils.device import check_on, resolve_device
from minimax_speech_torch.utils.params_io import named_flax_params

LM_NORM_GROUPS = {"llm": "llm/", "decoder": "llm_decoder",
                  "speech_emb": "speech_embedding"}
# substrings of flax paths, as JAX matches them: "encoder" also takes the
# speaker encoder and encoder_proj
FLOW_NORM_GROUPS = {"encoder": "encoder", "estimator": "estimator"}


@dataclass
class TrainState:
    """module (its parameters are the float32 masters), optimizer, its
    state, and the count of steps taken (micro-steps under
    accumulation); under a mesh, the mesh and each parameter's
    parallel.mesh.LeafLayout."""
    module: nn.Module
    optimizer: Optimizer
    opt_state: OptState
    step: int = 0
    mesh: Optional[Mesh] = None
    layouts: Optional[list] = None

    def params(self) -> list:
        """The parameters in the optimizer state's order."""
        return [p for _, p in named_flax_params(self.module)]

    @property
    def dp_group(self):
        """The group the global batch is split over (None: whole)."""
        return None if self.mesh is None else self.mesh.dp_group


def make_train_state(module: nn.Module, optimizer: Optimizer,
                     mesh: Optional[Mesh] = None,
                     kind: str = "lm") -> TrainState:
    """The state of `module`. With a mesh (parallel.mesh.make_mesh),
    `module`, holding the full weights, is put in place on this rank's
    tensor-parallel slices under the `kind` rules ("lm", "llm" or
    "flow"), and the optimizer's state on its ZeRO-2 slices."""
    layouts = None if mesh is None else shard_module(module, mesh, kind)
    params = [p for _, p in named_flax_params(module)]
    return TrainState(module, optimizer,
                      optimizer.init(params, layouts, mesh), mesh=mesh,
                      layouts=layouts)


def grad_norms_by_component(named_grads, groups: dict[str, str],
                            layouts=None, mesh=None) -> dict:
    """L2 norm per named component; groups maps name -> a substring of
    the parameter's flax path. Under a mesh, of the whole leaves."""
    if mesh is not None:
        subsets = [[i for i, (path, _) in enumerate(named_grads)
                    if needle in path] for needle in groups.values()]
        norms = global_norms([g for _, g in named_grads], subsets, layouts,
                             mesh)
        return {f"grad_norm/{name}": n for name, n in zip(groups, norms)}
    out = {}
    for name, needle in groups.items():
        sel = [g for path, g in named_grads if needle in path]
        out[f"grad_norm/{name}"] = global_norm(sel) if sel \
            else torch.zeros(())
    return out


def dp_sum(state: TrainState, metrics: dict) -> dict:
    """Metrics that are this rank's shares of the global batch's, summed
    over dp in one all-reduce (as they are without a mesh)."""
    group = state.dp_group
    if group is None:
        return metrics
    vals = torch.stack([v.detach().float() for v in metrics.values()])
    dist.all_reduce(vals, group=group)
    return dict(zip(metrics, vals.unbind()))


def speaker_of(model, batch: dict):
    """The LM's speaker conditioning (B, C): the batch's reference mels
    (+ lengths) through the speaker encoder, or its spk_emb."""
    if "reference_mel" in batch:
        return model.embed_speaker(batch["reference_mel"],
                                   _reference_mask(batch))
    return batch["spk_emb"]


def _reference_mask(batch: dict):
    """The reference mels' (B, T) frame mask, or None without lengths."""
    if "reference_mel_len" not in batch:
        return None
    t = batch["reference_mel"].shape[1]
    return (torch.arange(t, device=batch["reference_mel"].device)[None]
            < batch["reference_mel_len"][:, None])


class _LMLoss(nn.Module):
    """The LM loss as one module call, so that functional_call can swap
    in bf16 parameters: speaker conditioning from the batch's reference
    mels (the speaker encoder trains jointly) or its spk_emb, then the
    plan forward."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch: dict, group=None):
        m = self.model
        return m(batch["src_type"], batch["tok_id"], batch["target"],
                 batch["seq_len"], speaker_of(m, batch), group=group)


class _FlowLoss(nn.Module):
    """The flow loss as one module call: the speaker embedding from the
    batch's reference mels through the speaker encoder (detached when
    cfg.freeze_speaker_encoder, as the JAX step stops its gradient) or
    the batch's embedding, then the CFM loss."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch: dict, draws, streaming: bool = False,
                group=None):
        m = self.model
        if "reference_mel" in batch:
            emb = m.embed_speaker(batch["reference_mel"],
                                  _reference_mask(batch))
            if m.cfg.freeze_speaker_encoder:
                emb = emb.detach()
        else:
            emb = batch["embedding"]
        return m(batch["token"], batch["token_len"], batch["feat"],
                 batch["feat_len"], emb, draws, streaming=streaming,
                 group=group)


def _cast_floats(batch: dict, dtype) -> dict:
    return {k: v.to(dtype) if torch.is_floating_point(v) else v
            for k, v in batch.items()}


def _loss_fn(wrapper: nn.Module, model, bf16: bool):
    """wrapper's call, or with bf16 its call through bfloat16 copies of
    the parameters and of the batch's float tensors."""
    def loss_fn(batch, *args, **kw):
        if not bf16:
            return wrapper(batch, *args, **kw)
        params = {f"model.{n}": p.to(torch.bfloat16)
                  for n, p in model.named_parameters()}
        return torch.func.functional_call(
            wrapper, params, (_cast_floats(batch, torch.bfloat16), *args),
            kw)

    return loss_fn


def make_lm_loss_fn(model, bf16: bool = False):
    """loss_fn(batch, group=None) -> (loss, acc): batch holds the plan
    tensors (src_type, tok_id, target, seq_len) and reference_mel (+
    reference_mel_len) or spk_emb, on the model's device; with `group`,
    this rank's shares of the global batch's."""
    return _loss_fn(_LMLoss(model), model, bf16)


def make_flow_loss_fn(model, bf16: bool = False):
    """loss_fn(batch, draws, streaming=False, group=None) -> loss: batch
    holds token, token_len, feat, feat_len and reference_mel (+
    reference_mel_len) or embedding, on the model's device; draws a
    models.flow.FlowDraws (this rank's rows of the global batch's, with
    `group`, and then the loss is this rank's share)."""
    return _loss_fn(_FlowLoss(model), model, bf16)


def make_lm_train_step(model, bf16: bool = False, device=None):
    """Returns step(state, batch) -> (state, metrics); metrics: loss, acc,
    grad_norm (before the clip) and grad_norm/<component>, as tensors.
    The model must live on `device` (default cuda, which raises without
    a GPU)."""
    check_on(model, resolve_device(device), "the LM")
    loss_fn = make_lm_loss_fn(model, bf16=bf16)
    names = [path for path, _ in named_flax_params(model)]

    def step(state: TrainState, batch):
        loss, acc = loss_fn(batch, group=state.dp_group)
        return state, _apply(state, loss, names, LM_NORM_GROUPS,
                             acc=acc.detach())

    return step


def make_flow_train_step(model, bf16: bool = False, device=None,
                         streaming: bool = False):
    """Returns step(state, batch, draws) -> (state, metrics); batch as
    make_flow_loss_fn takes it, draws a models.flow.FlowDraws. Metrics:
    loss, grad_norm (before the clip) and grad_norm/<component>. A frozen
    speaker encoder gets zero gradients, so with no weight decay AdamW
    leaves it as it is. The model must live on `device` (default cuda,
    which raises without a GPU)."""
    check_on(model, resolve_device(device), "the flow model")
    loss_fn = make_flow_loss_fn(model, bf16=bf16)
    names = [path for path, _ in named_flax_params(model)]

    def step(state: TrainState, batch, draws):
        loss = loss_fn(batch, draws, streaming=streaming,
                       group=state.dp_group)
        return state, _apply(state, loss, names, FLOW_NORM_GROUPS)

    return step


def make_matcha_train_step(model, device=None):
    """Returns step(state, batch, draws) -> (state, metrics) for
    models/matcha.MatchaTTS: batch holds tokens, token_len, mels,
    mel_len on the model's device; draws a models.cfm.CFMDraws. The
    loss is dur + prior + cfm; metrics: loss, dur, prior, cfm. The model
    must live on `device` (default cuda, which raises without a GPU)."""
    check_on(model, resolve_device(device), "the Matcha model")

    def step(state: TrainState, batch, draws):
        dur, prior, cfm = model(batch["tokens"], batch["token_len"],
                                batch["mels"], batch["mel_len"], draws)
        loss = dur + prior + cfm
        backward_and_update(state, loss)
        return state, {"loss": loss.detach(), "dur": dur.detach(),
                       "prior": prior.detach(), "cfm": cfm.detach()}

    return step


def backward_and_update(state: TrainState, loss) -> list:
    """Backward of `loss` into the state's parameters, the optimizer's
    update (clip, accumulation, AdamW; it leaves the gradients as they
    are) and one step on the counter. Returns the gradients (`gradients`).
    """
    grads = gradients(state, loss)
    state.optimizer.apply(state.params(), grads, state.opt_state,
                          state.layouts, state.mesh)
    state.step += 1
    return grads


def gradients(state: TrainState, loss) -> list:
    """The gradients of `loss` (this rank's share under a mesh) for the
    state's parameters, zeros where a parameter gets none; under a mesh
    the global batch's: summed over dp (the partial ones over tp
    first), each whole over dp and this rank's slice over tp."""
    params = state.params()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    mesh = state.mesh
    if mesh is not None:
        all_reduce_buckets([g for g, lay in zip(grads, state.layouts)
                            if lay.partial], mesh.tp_group)
        all_reduce_buckets(grads, mesh.dp_group)
    return grads


def _apply(state: TrainState, loss, names, groups, **shares) -> dict:
    """backward_and_update; returns loss (and the other `shares` of the
    global batch's metrics), grad_norm and grad_norm/<component>."""
    grads = backward_and_update(state, loss)
    mesh, lay = state.mesh, state.layouts
    return {**dp_sum(state, {"loss": loss.detach(), **shares}),
            "grad_norm": global_norm(grads, lay, mesh),
            **grad_norms_by_component(list(zip(names, grads)), groups, lay,
                                      mesh)}
