"""The port's multi-process layouts, static-shape data stages, launcher
and CLI checks against the JAX package, in one process on the CPU.

- The partition rules and ZeRO-2 layouts: every leaf of the full-width
  LM and flow (JAX through jax.eval_shape, the port on the meta device)
  at meshes (2, 2), (4, 2), (2, 4) and (1, 8): the port's tp split is
  param_shardings's spec, and each Adam moment's local shape the shard
  shape of opt_state_shardings's. The one departure: an attention whose
  heads tp does not divide keeps its projections replicated in the port
  (parallel/mesh.py), and its moments follow JAX's rule on that
  replicated leaf.
- The data stages multi-process training runs, identical to JAX's: the
  DataList partitions, filter_static_shapes, static_batch,
  padding_llm(pad_to, pad_ref, dpo) and padding_flow(pad_tokens,
  pad_ref), with Python's `random` seeded the same way.
- The elastic launcher with a stub worker: the restart counter reaches
  the worker, the gang is given up after --max_restarts, and SIGTERM
  shuts it down without a restart.
- The training CLI refuses --dp 2 without --distributed.
"""
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from minimax_speech_torch import config as t_config
from minimax_speech_torch.cli import train as t_cli
from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_torch.models import decoder_unet as t_unet
from minimax_speech_torch.models import flow as t_flow
from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.models import qwen2 as t_qwen2
from minimax_speech_torch.parallel import mesh as t_mesh
from minimax_speech_tpu import config as j_config
from minimax_speech_tpu.data import pipeline as j_dp
from minimax_speech_tpu.models import flow as j_flow
from minimax_speech_tpu.models import llm as j_llm
from minimax_speech_tpu.parallel import mesh as j_mesh
from minimax_speech_tpu.train import schedule as j_sched
from tests import torch_cpu

torch_cpu.share_cores()

REPO = Path(__file__).resolve().parent.parent
MESHES = [(2, 2), (4, 2), (2, 4), (1, 8)]


@pytest.fixture(scope="module")
def full_models():
    """{kind: (JAX params shapes, the port's module on the meta device)}
    at the widths of configs/default.yaml."""
    jcfg = j_config.load_tts_config(REPO / "configs/default.yaml")
    pcfg = t_config.load_tts_config(REPO / "configs/default.yaml")
    key = jax.random.PRNGKey(0)
    lm, fl = j_llm.SpeechLM(jcfg.lm), j_flow.FlowModel(jcfg.flow)
    shapes = {
        "lm": jax.eval_shape(lambda k: j_llm.init_lm_variables(lm, k),
                             key)["params"],
        "flow": jax.eval_shape(lambda k: j_flow.init_flow_variables(fl, k),
                               key)["params"]}
    with torch.device("meta"):
        ports = {"lm": t_llm.SpeechLM(pcfg.lm),
                 "flow": t_flow.FlowModel(pcfg.flow)}
    return {k: (shapes[k], ports[k]) for k in shapes}


def _spec_dim(spec, axis="tp"):
    """The dim of a PartitionSpec that `axis` splits, or None."""
    for dim, a in enumerate(spec):
        if a == axis or (isinstance(a, tuple) and axis in a):
            return dim
    return None


def _flax_specs(layouts, module) -> dict:
    """{flax path: (the flax dim split over tp, the flax dim of the
    moments split over dp)} of the port's layouts (torch dims)."""
    out = {}
    params = [(mod, pname, p) for _, mod in module.named_modules()
              for pname, p in mod.named_parameters(recurse=False)]
    for lay, (mod, pname, p) in zip(layouts, params):
        fshape, to_torch = t_mesh.flax_shape_and_dim_map(mod, pname,
                                                         p.shape)
        back = {to_torch(d): d for d in range(len(fshape))}
        out[lay.path] = (back.get(lay.tp_dim), back.get(lay.zero_dim))
    return out


def _replicated_heads(module, tp) -> set:
    """Flax paths of the projections the port keeps replicated: those of
    attentions whose heads tp does not divide."""
    out = set()
    for name, mod in module.named_modules():
        heads = t_mesh.attention_heads(mod)
        if heads and any(h % tp for h in heads[0]):
            out.update(f"{name.replace('.', '/')}/{p}" for p in heads[1])
    return out


@pytest.mark.parametrize("dp,tp", MESHES)
@pytest.mark.parametrize("kind", ["lm", "flow"])
def test_layouts_match_jax(full_models, kind, dp, tp):
    shapes, module = full_models[kind]
    mesh = j_mesh.make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
    jsh = j_mesh.param_shardings(mesh, shapes, kind)
    layouts = t_mesh.param_layouts(module, t_mesh.Mesh(dp, tp), kind)
    ours = _flax_specs(layouts, module)
    flat = {j_mesh._path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(jsh)[0]}
    leaf_shapes = {j_mesh._path_str(p): s.shape for p, s in
                   jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert ours.keys() == flat.keys()
    kept = _replicated_heads(module, tp)
    departed = set()
    for path, sharding in flat.items():
        theirs = _spec_dim(sharding.spec)
        if ours[path][0] != theirs:
            assert ours[path][0] is None and path.rsplit("/", 1)[0] in kept, (
                path, ours[path][0], theirs)
            departed.add(path)
    # the departure exists exactly where tp does not divide the heads
    heads = ([module.cfg.qwen.n_heads, module.cfg.qwen.n_kv_heads]
             if kind == "lm" else [module.cfg.unet.num_heads])
    assert bool(departed) == any(h % tp for h in heads), sorted(departed)
    # moments: JAX's zero_shard rule on the port's param layout
    ported = jax.tree_util.tree_map_with_path(
        lambda p, s: NamedSharding(mesh, P()) if j_mesh._path_str(p)
        in departed else s, jsh)
    opt_shape = jax.eval_shape(
        j_sched.make_optimizer(lr=1e-3, warmup_steps=1).init, shapes)
    osh = j_mesh.opt_state_shardings(mesh, opt_shape, ported)
    moments = {}
    for p, s in jax.tree_util.tree_flatten_with_path(osh)[0]:
        ps = j_mesh._path_str(p)
        if "/.mu/" in ps:  # optax's ScaleByAdamState.mu
            moments[ps.split("/.mu/", 1)[1]] = s
    assert moments.keys() == flat.keys()
    for path, (tp_dim, zero_dim) in ours.items():
        shape = list(leaf_shapes[path])
        if tp_dim is not None:
            shape[tp_dim] //= tp
        if zero_dim is not None:
            shape[zero_dim] //= dp
        assert tuple(shape) == moments[path].shard_shape(
            leaf_shapes[path]), path


def test_lm_attention_kept_whole_at_tp4():
    """Qwen2-0.5B's 14 q and 2 kv heads at tp = 4: the port keeps q/k/v/o
    replicated and splits the MLP."""
    cfg = t_qwen2.Qwen2Config()
    with torch.device("meta"):
        module = t_qwen2.Qwen2Model(t_qwen2.Qwen2Config(n_layers=1))
        block = t_unet.UNetTransformerBlock(256, 8, 64)
    lay = {x.path: x for x in t_mesh.param_layouts(
        module, t_mesh.Mesh(1, 4), "lm")}
    assert (cfg.n_heads, cfg.n_kv_heads) == (14, 2)
    assert lay["layers_0/self_attn/q_proj/kernel"].tp_dim is None
    assert lay["layers_0/mlp/gate_proj/kernel"].tp_dim == 0
    assert lay["layers_0/mlp/down_proj/kernel"].tp_dim == 1
    flow = {x.path: x for x in t_mesh.param_layouts(
        block, t_mesh.Mesh(1, 2), "flow")}
    assert flow["to_q/kernel"].tp_dim == 0 and flow["to_out/kernel"].tp_dim \
        == 1


# -- the data stages ---------------------------------------------------------

def _samples(rng, n=11, dpo=False, flow=False):
    out = []
    for i in range(n):
        s = {"text_token": rng.integers(1, 256, int(rng.integers(3, 12))),
             "speech_token": rng.integers(0, 6561, int(rng.integers(5, 60))),
             "reference_mels": [rng.standard_normal(
                 (int(rng.integers(20, 90)), 80)).astype(np.float32)]}
        if dpo and i % 4:
            s["reject_speech_token"] = rng.integers(
                0, 6561, int(rng.integers(0, 60)))
        if flow:
            s["speech_latent"] = rng.standard_normal(
                (2 * len(s["speech_token"]), 80)).astype(np.float32)
        out.append(s)
    return out


def _same(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif isinstance(a, list):
            _same(a, b)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(), dict(process_index=1, process_count=2),
    dict(process_index=2, process_count=3),
    dict(shuffle=False, partition=False, process_index=1, process_count=2)])
def test_datalist_partitions_match_jax(kw):
    items = [{"src": f"utt{i}.wav"} for i in range(23)]
    for epoch in (0, 3):
        ours, theirs = t_dp.DataList(items, **kw), j_dp.DataList(items, **kw)
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)


@pytest.mark.parametrize("kind,dpo", [("llm", False), ("llm", True),
                                      ("flow", False)])
def test_static_stages_match_jax(rng, kind, dpo):
    """filter_static_shapes, static_batch(drop_last) and the fixed-pad
    padding stage, JAX's arrays exactly."""
    data = _samples(rng, dpo=dpo, flow=kind == "flow")
    out = {}
    for name, dp in (("port", t_dp), ("jax", j_dp)):
        random.seed(5)
        kept = list(dp.filter_static_shapes(iter(data), kind, 48, dpo=dpo))
        batches = list(dp.static_batch(iter(kept), 3, drop_last=True))
        assert all(len(b) == 3 for b in batches)
        if kind == "llm":
            padded = list(dp.padding_llm(iter(batches), dpo=dpo, pad_to=64,
                                         pad_ref=48))
        else:
            padded = list(dp.padding_flow(iter(batches), pad_tokens=48,
                                          pad_ref=48))
        out[name] = (kept, batches, padded,
                     list(dp.static_batch(iter(kept), 3, drop_last=False)))
    _same([s["speech_token"] for s in out["port"][0]],
          [s["speech_token"] for s in out["jax"][0]])
    _same([[s["speech_token"] for s in b] for b in out["port"][3]],
          [[s["speech_token"] for s in b] for b in out["jax"][3]])
    _same(out["port"][2], out["jax"][2])
    for b in out["port"][2]:  # fixed shapes
        assert b["reference_mel"].shape[1] == 48
        key = "src_type" if kind == "llm" else "token"
        assert b[key].shape[1] == (64 if kind == "llm" else 48)


def test_padding_drops_over_long_as_jax(rng):
    """Without the filter, the fixed-pad stages drop what does not fit, as
    JAX's do."""
    data = _samples(rng, n=6, dpo=True, flow=True)
    for s in data:
        s["reject_speech_token"] = s.get("reject_speech_token",
                                         np.arange(70) % 6561)
    for name in ("padding_llm", "padding_flow"):
        outs = []
        for dp in (t_dp, j_dp):
            random.seed(1)
            kw = dict(dpo=True, pad_to=50, pad_ref=40) \
                if name == "padding_llm" else dict(pad_tokens=30, pad_ref=40)
            outs.append(list(getattr(dp, name)(iter([data[:3], data[3:]]),
                                                 **kw)))
        _same(*outs)


# -- the launcher ------------------------------------------------------------

STUB = '''
import argparse, os, signal, sys, time
from pathlib import Path
p = argparse.ArgumentParser()
p.add_argument("--out"); p.add_argument("--fail_until", type=int)
p.add_argument("--sleep", type=float, default=0)
p.add_argument("--process_id", type=int)
a, _ = p.parse_known_args()
n = int(os.environ["MSTORCH_RESTART_COUNT"])
Path(a.out, f"rank{a.process_id}.attempt{n}").write_text(" ".join(sys.argv))
if a.sleep:
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    time.sleep(a.sleep)
sys.exit(3 if a.process_id == 1 and n < a.fail_until else 0)
'''


def _launch(tmp_path, *worker, max_restarts=2, popen=False):
    (tmp_path / "stub_worker.py").write_text(STUB)
    cmd = [sys.executable, "-m", "minimax_speech_torch.cli.launch",
           "--nproc", "2", "--max_restarts", str(max_restarts), "--module",
           "stub_worker", "--device", "cpu", "--log_dir",
           str(tmp_path / "logs"), "--state_file", str(tmp_path / "gang.json"),
           "--", "--out", str(tmp_path), *worker]
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}:{REPO}"}
    if popen:
        return subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)


def test_launcher_restarts_the_gang_with_the_counter(tmp_path):
    """Rank 1 fails on attempts 0 and 1: the whole gang is relaunched
    twice, each worker seeing its attempt number, with its rank, the
    world size and --device forwarded; the third attempt succeeds."""
    r = _launch(tmp_path, "--fail_until", "2", max_restarts=2)
    assert r.returncode == 0, r.stdout + r.stderr
    for attempt in range(3):
        for rank in range(2):
            argv = (tmp_path / f"rank{rank}.attempt{attempt}").read_text()
            assert f"--process_id {rank}" in argv
            assert "--num_processes 2" in argv and "--device cpu" in argv
            assert "--distributed --coordinator 127.0.0.1:" in argv


def test_launcher_gives_up_after_max_restarts(tmp_path):
    r = _launch(tmp_path, "--fail_until", "9", max_restarts=1)
    assert r.returncode == 1
    assert "giving up after 2 attempts" in r.stderr
    assert not (tmp_path / "rank1.attempt2").exists()


def test_launcher_sigterm_shuts_down_without_restart(tmp_path):
    proc = _launch(tmp_path, "--fail_until", "0", "--sleep", "60",
                   popen=True)
    try:
        deadline = time.time() + 60
        while not all((tmp_path / f"rank{r}.attempt0").exists()
                      for r in range(2)):
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "shutdown requested; not restarting" in out
    assert not list(tmp_path.glob("rank*.attempt1"))


def test_cli_dp_without_distributed_raises(tmp_path):
    with pytest.raises(ValueError, match="cli.launch"):
        t_cli.main(["--model", "llm", "--config", "configs/tiny.yaml",
                    "--train_data", str(tmp_path / "x"), "--model_dir",
                    str(tmp_path), "--device", "cpu", "--dp", "2"])
