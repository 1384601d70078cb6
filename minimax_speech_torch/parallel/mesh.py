"""The dp x tp layout of the ranks, the tensor-parallel partition rules,
and the ZeRO-2 layout of the optimizer's state.

Port of minimax_speech_tpu/parallel/mesh.py, one process per GPU. The
JAX package lays a device mesh over one process's devices and lets XLA
insert the collectives; here each rank holds plain local tensors and the
collectives are explicit (parallel/layers.py, train/schedule.py):

  dp   data parallel: each dp rank takes its share of the global batch;
       the gradients are all-reduced over dp
  tp   tensor parallel (Megatron-style): q/k/v/gate/up and the UNet's
       to_q/to_k/to_v/ff_in and the conformer's w_1 column-parallel,
       o/down and to_out/ff_out/w_2 row-parallel, the LM's embeddings
       vocab-parallel and its llm_decoder column-parallel over the logits

Rank r sits at dp index r // tp and tp index r % tp, as
np.asarray(devices).reshape(dp, tp) lays the devices out. The rules are
the JAX package's regexes over the "/"-joined flax paths
(utils/params_io.named_flax_params); each names the flax dim a leaf is
split on, and a leaf whose dim does not divide stays replicated, as in
JAX. One departure: an attention whose heads tp does not divide (the
Qwen2-0.5B LM's 14 q and 2 kv heads at tp = 4) keeps its projections
replicated, where JAX shards the q kernel into 3.5 heads a device and
lets XLA reshard; the function is the same.

ZeRO-2 (`zero_dim`, JAX's zero_shard): each moment takes its parameter's
tp split and also splits its largest free dim that dp divides over dp,
or, with every dim tp-split, the tp-split dim again when tp * dp divides
it; a dp rank keeps and updates only that slice.

A flax kernel is (in, out) and a torch Linear weight (out, in), a flax
conv kernel (k, in, out) and a torch Conv1d weight (out, in, k): the flax
dim i of such a leaf is torch dim ndim - 1 - i.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist
from torch import nn

from minimax_speech_torch.utils.params_io import flax_leaf_name

# path regex -> the flax dim split over tp
LM_RULES = [
    (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj).*kernel", 1),
    (r".*(q_proj|k_proj|v_proj).*bias", 0),
    (r".*(o_proj|down_proj).*kernel", 0),
    (r".*(text_embedding|speech_embedding).*embedding", 0),
    (r".*llm_decoder.*kernel", 1),
]
FLOW_RULES = [
    (r".*(to_q|to_k|to_v|ff_in|w_1).*kernel", 1),
    (r".*(to_out|ff_out|w_2).*kernel", 0),
]
RULES = {"lm": LM_RULES, "llm": LM_RULES, "flow": FLOW_RULES}
# column-parallel layers whose output the next op needs whole: gathered
GATHERED = ("llm_decoder",)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp x tp world and its two groups (None
    outside torch.distributed)."""
    dp: int
    tp: int
    dp_rank: int = 0
    tp_rank: int = 0
    dp_group: object = None
    tp_group: object = None

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def rank(self) -> int:
        return self.dp_rank * self.tp + self.tp_rank

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The mesh over the initialized world (world size 1 without
    torch.distributed): dp * tp must equal the world size; dp defaults
    to world // tp. Every rank must call it, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp = world // tp if dp is None else dp
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"dp ({dp}) x tp ({tp}) != world size ({world})")
    if not dist.is_initialized():
        return Mesh(dp, tp)
    rank = dist.get_rank()
    groups = {}
    for i in range(dp):  # every rank creates every group, in one order
        g = dist.new_group(list(range(i * tp, (i + 1) * tp)))
        if i == rank // tp:
            groups["tp"] = g
    for j in range(tp):
        g = dist.new_group([j + k * tp for k in range(dp)])
        if j == rank % tp:
            groups["dp"] = g
    return Mesh(dp, tp, rank // tp, rank % tp, groups["dp"], groups["tp"])


def flax_spec(path: str, shape, tp: int, rules) -> Optional[int]:
    """The flax dim of `path` (flax shape `shape`) split over tp, or None:
    the first matching rule, kept only when tp divides that dim."""
    for pat, dim in rules:
        if re.fullmatch(pat, path):
            if dim < len(shape) and shape[dim] % tp == 0:
                return dim
            return None
    return None


def zero_dim(spec: Optional[int], shape, tp: int, dp: int) -> Optional[int]:
    """JAX's zero_shard on a flax shape: the dim of a moment split over
    dp (the largest free dim dp divides, else the tp-split dim when
    tp * dp divides it), or None."""
    if dp <= 1:
        return None
    best, best_size = None, 0
    for dim, n in enumerate(shape):
        if dim != spec and n % dp == 0 and n > best_size:
            best, best_size = dim, n
    if best is not None:
        return best
    if spec is not None and shape[spec] % (tp * dp) == 0:
        return spec
    return None


def flax_shape_and_dim_map(mod: nn.Module, pname: str, shape):
    """(the flax shape of a torch parameter, flax dim -> torch dim)."""
    if flax_leaf_name(mod, pname) in ("kernel", "kernel_q"):
        n = len(shape)
        return tuple(reversed(shape)), lambda d: n - 1 - d
    return tuple(shape), lambda d: d


def attention_heads(mod: nn.Module):
    """The head counts tp must divide to shard this attention module,
    and its projections' names; None for other modules."""
    from minimax_speech_torch.models import decoder_unet, qwen2
    if isinstance(mod, qwen2.Qwen2Attention):
        return ((mod.cfg.n_heads, mod.cfg.n_kv_heads),
                ("q_proj", "k_proj", "v_proj", "o_proj"))
    if isinstance(mod, decoder_unet.UNetTransformerBlock):
        return (mod.num_heads,), ("to_q", "to_k", "to_v", "to_out")
    return None


@dataclass(frozen=True)
class LeafLayout:
    """How one parameter lies on this rank, in torch dims.

    tp_dim: the dim split over tp (None: replicated over tp).
    zero_dim: the dim of the tp-local tensor split over dp for the
      optimizer's state and update (None: every dp rank updates it all).
    partial: replicated over tp, but each tp rank's gradient covers only
      its own slice (the bias of a column-parallel layer whose rule splits
      only the kernel); the gradients are summed over tp."""
    path: str
    tp_dim: Optional[int] = None
    zero_dim: Optional[int] = None
    partial: bool = False


def param_layouts(module: nn.Module, mesh: Mesh, kind: str) -> list:
    """The LeafLayout of every parameter of the full (unsharded) `module`,
    in named_flax_params order, under `mesh` and the `kind` rules ("lm",
    "llm" or "flow")."""
    rules = RULES[kind]
    replicated = set()
    for name, mod in module.named_modules():
        heads = attention_heads(mod)
        if heads and any(h % mesh.tp for h in heads[0]):
            replicated.update(f"{name}.{p}" if name else p
                              for p in heads[1])
    out = []
    for mname, mod in module.named_modules():
        flax_prefix = "/".join(mname.split(".")) if mname else ""
        for pname, p in mod.named_parameters(recurse=False):
            path = "/".join(filter(None, (flax_prefix,
                                          flax_leaf_name(mod, pname))))
            fshape, to_torch = flax_shape_and_dim_map(mod, pname, p.shape)
            spec = None if mname in replicated else flax_spec(
                path, fshape, mesh.tp, rules)
            z = zero_dim(spec, fshape, mesh.tp, mesh.dp)
            out.append(LeafLayout(
                path, None if spec is None else to_torch(spec),
                None if z is None else to_torch(z)))
    return out
