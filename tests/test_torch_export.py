"""cli/export.py of the port on the CPU, at configs/tiny.yaml.

A spy on each of the four stages shows export calling each once per
bucket at the shapes of the JAX loop (minimax_speech_tpu/cli/export.py:
the tokenizer on a (1, b, n_mels) zero mel, the flow on (1, b) tokens
with a 16-frame prompt and the pipeline's noise, the codec on (1, 2b, 80),
the LM's generate on a (1, b) prompt opened by SRC_SPECIAL with prompt
length 4, min length 1, max length 2 and max_steps from --gen_tokens or
the config). --serving reaches warm_serving for both schedulers and
leaves no speaker behind, --matcha reaches matcha_synthesise and the
vocoder per bucket, a --ckpt_dir of .npz files written by the JAX
package's save_params loads, and export refuses the CPU unasked and a
run without weights.
"""
import numpy as np
import pytest
import torch

from minimax_speech_torch import config as t_config
from minimax_speech_torch.cli import export
from minimax_speech_torch.infer import warmup
from minimax_speech_torch.infer.pipeline import TTSPipeline
from minimax_speech_torch.models import flow as flow_mod
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.models import matcha as matcha_mod
from minimax_speech_torch.models.s3tokenizer import S3TokenizerV2
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.utils import params_io as j_io
from tests import torch_cpu

torch_cpu.share_cores()

CONFIG = "configs/tiny.yaml"
BASE = ["--config", CONFIG, "--device", "cpu"]
FILES = ("llm", "flow", "codec", "s3")  # TTSPipeline.models()' order


def spy(monkeypatch, owner, name, calls, label):
    """Wrap owner.name so each call appends (label, args, kwargs)."""
    real = getattr(owner, name)

    def run(*a, **kw):
        calls.append((label, a, kw))
        return real(*a, **kw)
    monkeypatch.setattr(owner, name, run)


def shape(x):
    return tuple(torch.as_tensor(x).shape)


def values(x):
    return torch.as_tensor(x).tolist()


@pytest.mark.parametrize("gen_tokens", [None, 5])
def test_stages_once_per_bucket_at_jax_shapes(gen_tokens, monkeypatch):
    cfg = t_config.load_tts_config(CONFIG)
    calls = []
    spy(monkeypatch, S3TokenizerV2, "forward", calls, "s3")
    spy(monkeypatch, flow_mod, "flow_inference", calls, "flow")
    spy(monkeypatch, TTSPipeline, "decode", calls, "decode")
    spy(monkeypatch, llm_mod, "generate", calls, "llm")
    extra = [] if gen_tokens is None else ["--gen_tokens", str(gen_tokens)]
    rec = export.main(BASE + ["--random_init", "--buckets", "16,32"]
                      + extra)
    assert [c[0] for c in calls] == ["s3", "flow", "decode", "llm"] * 2
    for i, b in enumerate((16, 32)):
        s3, flow, decode, llm = calls[4 * i: 4 * i + 4]
        _, mel, lens = s3[1]
        assert shape(mel) == (1, b, cfg.s3.n_mels) and values(lens) == [b]
        assert not torch.as_tensor(mel).any()
        model, tokens, token_len, prompt, emb, noise = flow[1]
        assert isinstance(model, flow_mod.FlowModel)
        assert shape(tokens) == (1, b) and values(token_len) == [b]
        assert shape(prompt) == (1, 16, cfg.flow.output_size)
        assert shape(emb) == (1, cfg.flow.spk_embed_dim)
        assert shape(noise) == (1, 15000, cfg.flow.output_size)
        assert shape(decode[1][1]) == (1, 2 * b, cfg.flow.output_size)
        model, src, tok, plen, spk, min_len, max_len = llm[1]
        want = np.zeros((1, b), np.int64)
        want[0, 0] = llm_mod.SRC_SPECIAL
        assert values(src) == want.tolist() and not torch.as_tensor(
            tok).any() and shape(tok) == (1, b)
        assert values(plen) == [4]
        assert shape(spk) == (1, cfg.lm.llm_input_size)
        assert values(min_len) == [1] and values(max_len) == [2]
        assert llm[2]["max_steps"] == (gen_tokens or cfg.max_speech_tokens)
        assert isinstance(llm[2]["generator"], torch.Generator)
        assert set(rec["buckets"][b]) == {"s3_s", "flow_s", "decode_s",
                                          "llm_s"}
        assert all(v >= 0 for v in rec["buckets"][b].values())
    assert rec["device"] == "cpu" and rec["kernels"] == {}
    assert rec["serving"] == {} and rec["matcha"] == {}


def test_serving_and_matcha(monkeypatch):
    calls = []
    spy(monkeypatch, matcha_mod, "matcha_synthesise", calls, "matcha")
    ttses = []
    real = warmup.warm_serving

    def warm(tts, **kw):
        ttses.append(tts)
        calls.append(("warm", (), kw))
        return real(tts, **kw)
    monkeypatch.setattr(warmup, "warm_serving", warm)
    rec = export.main(BASE + ["--random_init", "--buckets", "16",
                              "--serving", "--matcha"])
    assert [(c[0], c[2]) for c in calls if c[0] == "warm"] == [
        ("warm", {"scheduler": "window"}),
        ("warm", {"scheduler": "continuous", "streaming": False})]
    assert ttses[0] is ttses[1] and ttses[0].spk2info == {}
    assert ttses[0].list_available_spks() == []
    matcha = [c for c in calls if c[0] == "matcha"]
    assert len(matcha) == 1 and shape(matcha[0][1][1]) == (1, 16)
    assert isinstance(matcha[0][2]["generator"], torch.Generator)
    assert set(rec["matcha"][16]) == {"synthesise_s", "vocoder_s"}
    assert set(rec["serving"]["window"]) >= {"one_shot_s", "batch1_s",
                                             "batch8_s", "streaming_s"}
    assert set(rec["serving"]["continuous"]) == {"one_shot_s",
                                                 "continuous_s"}


def test_ckpt_dir_of_jax_files_loads(tmp_path, monkeypatch):
    """{llm,flow,codec,s3}.npz written by the JAX package's save_params
    from a seeded port pipeline's trees: the pipeline export builds holds
    those arrays."""
    cfg = t_config.load_tts_config(CONFIG)
    src = TTSPipeline.from_random(cfg, seed=3, device="cpu")
    for name, m in zip(FILES, src.models().values()):
        j_io.save_params(str(tmp_path / f"{name}.npz"),
                         t_io.to_flax_params(m))
    built = []
    real = TTSPipeline.from_flax.__func__

    def from_flax(cls, *a, **kw):
        built.append(real(cls, *a, **kw))
        return built[-1]
    monkeypatch.setattr(TTSPipeline, "from_flax", classmethod(from_flax))
    export.main(BASE + ["--ckpt_dir", str(tmp_path), "--buckets", "16"])
    assert len(built) == 1
    for name, module in zip(FILES, built[0].models().values()):
        got = t_io.to_flax_params(module)
        want = t_io.load_params(str(tmp_path / f"{name}.npz"))
        flat_got, flat_want = t_io._flatten(got), t_io._flatten(want)
        assert flat_got.keys() == flat_want.keys(), name
        for k, a in flat_want.items():
            np.testing.assert_array_equal(flat_got[k], a,
                                          err_msg=f"{name} {k}")


def test_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="--ckpt_dir or --random_init"):
        export.main(BASE + ["--buckets", "16"])
    # the default device is cuda: no GPU, no run (and no CPU fallback)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main(["--config", CONFIG, "--random_init", "--buckets", "16"])
