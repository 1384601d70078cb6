"""The jobs of the port's multi-process tests, run on every rank of a
utils/gang.Gang of gloo ranks on the CPU (this module is its job table):
each takes the rank's mesh-free world (every rank in one gloo world) and
numpy arguments. This module imports no JAX (the ranks need none).
"""
from __future__ import annotations


# -- jobs: each runs on every rank -------------------------------------------

def _mesh(dp, tp):
    from minimax_speech_torch.parallel import mesh as mesh_lib
    return mesh_lib.make_mesh(dp, tp)


def _rows(batch: dict, mesh) -> dict:
    """This dp rank's rows of a global numpy batch, as tensors."""
    import torch
    b = next(iter(batch.values())).shape[0] // mesh.dp
    sl = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
    return {k: torch.as_tensor(v[sl]) for k, v in batch.items()}


def _whole(state, tensors) -> list:
    """numpy flax-layout whole leaves of this rank's slices (`tensors`
    aligned with the state's layouts), {flax path tuple: array}."""
    from minimax_speech_torch.parallel.collectives import full_tensors
    from minimax_speech_torch.utils import params_io
    whole = full_tensors([t.detach() for t in tensors], state.layouts,
                         state.mesh)
    return {path: to_flax(t.numpy()) for (path, _, _, to_flax), t in zip(
        params_io._params_with_paths(state.module), whole)}


def train_job(kind: str, model_cfg, tree: dict, batches: list,
              dp: int, tp: int, opt: dict, draws=None, ref_tree=None):
    """Steps of the LM ("llm"), DPO ("dpo") or flow ("flow") train step
    of the model of `model_cfg` (an LMConfig or FlowConfig) on a dp x tp
    mesh from the flax weights `tree`, one per global batch
    of `batches` (draws: the global batch's models.flow.FlowDraws per
    step; ref_tree: DPO's reference weights). Returns (metrics per step,
    the first step's whole gradients, the whole parameters after the
    steps), each gradient and parameter by flax path."""
    from minimax_speech_torch.models import flow as flow_mod
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.parallel.layers import shard_module
    from minimax_speech_torch.train import gan_steps, schedule, steps
    from minimax_speech_torch.utils import params_io

    mesh = _mesh(dp, tp)
    model = flow_mod.FlowModel(model_cfg) if kind == "flow" \
        else llm_mod.SpeechLM(model_cfg)
    params_io.load_flax_params(model, tree)
    state = steps.make_train_state(model, schedule.make_optimizer(**opt),
                                   mesh, kind="flow" if kind == "flow"
                                   else "lm")
    if kind == "dpo":
        ref = params_io.load_flax_params(llm_mod.SpeechLM(model_cfg),
                                         ref_tree)
        shard_module(ref, mesh, "lm")
        step = gan_steps.make_dpo_step(model, ref, device="cpu")
    elif kind == "flow":
        step = steps.make_flow_train_step(model, device="cpu")
    else:
        step = steps.make_lm_train_step(model, device="cpu")
    grads = {}
    real = steps.backward_and_update

    def keep_first(st, loss):  # the first step's gradients, whole
        g = real(st, loss)
        if not grads:
            grads.update(_whole(st, g))
        return g

    steps.backward_and_update = keep_first
    try:
        metrics = []
        for i, batch in enumerate(batches):
            args = (_rows(batch, mesh),)
            if kind == "flow":
                b = next(iter(batch.values())).shape[0] // dp
                args += (draws[i].rows(mesh.dp_rank * b, b),)
            state, m = step(state, *args)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        steps.backward_and_update = real
    return metrics, grads, _whole(state, state.params())


def checkpoint_job(lm_cfg, tree: dict, batch: dict, directory: str,
                   dp: int, tp: int, save: bool):
    """The LM of `lm_cfg` on a dp x tp mesh: with save, one step on
    `batch` and a checkpoint written to `directory`; else the newest checkpoint there
    restored. Returns (the step, whole parameters, whole moments mu and
    nu by flax path)."""
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.parallel.collectives import full_tensors
    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.train.checkpoint import CheckpointManager
    from minimax_speech_torch.utils import params_io

    mesh = _mesh(dp, tp)
    model = params_io.load_flax_params(llm_mod.SpeechLM(lm_cfg), tree)
    state = steps.make_train_state(
        model, schedule.make_optimizer(lr=1e-3, warmup_steps=0), mesh, "lm")
    ckpt = CheckpointManager(directory)
    if save:
        state, _ = steps.make_lm_train_step(model, device="cpu")(
            state, _rows(batch, mesh))
        ckpt.save(state.step, state)
    else:
        state, _ = ckpt.restore(state)
    paths = [lay.path for lay in state.layouts]
    moments = {key: dict(zip(paths, (t.numpy() for t in full_tensors(
        getattr(state.opt_state, key), state.layouts, mesh, zero=True))))
        for key in ("mu", "nu")}
    params = dict(zip(paths, (t.numpy() for t in full_tensors(
        [p.detach() for p in state.params()], state.layouts, mesh))))
    return state.step, params, moments


def join_job(counts: list):
    """agree_steps over the ranks' counts, and the batches
    uneven_join_batches yields from count[rank] local batches."""
    import torch.distributed as dist

    from minimax_speech_torch.utils import distributed
    n = counts[dist.get_rank()]
    return (distributed.agree_steps(n),
            list(distributed.uneven_join_batches(range(n), round_size=3)))
