"""The plain reference against the port on the CPU at the tiny test
geometry, module by module, on the benchmark's own weights."""
import copy

import numpy as np
import pytest
import torch

from speechbench import checks, program, weights
from speechbench.reference import llm as ref_llm
from speechbench.reference import models as ref_models
from speechbench.tests import support

torch.set_num_threads(2)
CPU = torch.device("cpu")


def model_block():
    m = copy.deepcopy(support.TINY["model"])
    m["output_type"] = "latent"
    return m


def test_lm_whole_plan_matches_prefill_then_cached_decode():
    from minimax_speech_torch.config import build_tts_config
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.models import qwen2
    from minimax_speech_torch.ops import masks
    serving = dict(support.TINY["serving"], lm_dtype="float32")
    model = model_block()
    cfg = build_tts_config(program.tts_data(model, serving))
    lm = llm_mod.SpeechLM(cfg.lm).eval()
    state = weights.make_state(lm, 11, CPU)
    lm.load_state_dict(state)
    rng = np.random.default_rng(0)
    r = type("R", (), {})()
    r.text_tokens = rng.integers(1, 500, 5)
    r.prompt_text_tokens = rng.integers(1, 500, 3)
    r.prompt_speech_tokens = rng.integers(0, 6561, 7)
    r.lm_spk = rng.standard_normal(cfg.lm.llm_input_size).astype(np.float32)
    served = rng.integers(0, 6561, 6)
    src, tok, n = llm_mod.build_inference_plan(
        np.concatenate([r.prompt_text_tokens, r.text_tokens]),
        r.prompt_speech_tokens)
    n = int(n[0])
    with torch.no_grad():
        emb = lm.embed_plan(torch.as_tensor(src).long(),
                            torch.as_tensor(tok).long(),
                            torch.as_tensor(r.lm_spk[None]))
        cache = qwen2.make_cache(cfg.lm.qwen, 1, n + len(served), emb.dtype)
        pad = masks.make_non_pad_mask(torch.tensor([n]), n)
        hidden = lm.prefill(emb, pad, torch.arange(n)[None], cache)
        got = [lm.llm_decoder(hidden[0, n - 1])]
        valid = torch.cat([pad, torch.zeros(1, len(served), dtype=torch.bool)],
                          1)
        for i, t in enumerate(served[:-1]):
            e1 = lm.embed_speech_token(torch.tensor([[int(t)]]))
            got.append(lm.decode_step(e1, torch.tensor([n + i]), valid, cache,
                                      n + i)[0])
    got = torch.stack(got)
    ref = checks.LMReference(model, state, serving, CPU)
    want = ref.served_logits(r, served)
    ok = torch.isfinite(want)
    assert checks.rel_err(got[ok], want[ok]) < 1e-5


@pytest.mark.parametrize("streaming", [False, True])
def test_flow_matches(streaming):
    from minimax_speech_torch.config import build_tts_config
    from minimax_speech_torch.models import flow as flow_mod
    model = model_block()
    cfg = build_tts_config(program.tts_data(model))
    fm = flow_mod.FlowModel(cfg.flow).eval()
    state = weights.make_state(fm, 12, CPU)
    fm.load_state_dict(state)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 6561, 20)
    pf = rng.standard_normal((12, 80)).astype(np.float32)
    emb = rng.standard_normal(cfg.flow.spk_embed_dim).astype(np.float32)
    noise = checks.fixed_noise(80, CPU)
    tok_pad = np.zeros((1, 32), np.int64)
    tok_pad[0, :20] = toks
    pf_pad = np.zeros((1, 16, 80), np.float32)
    pf_pad[0, :12] = pf
    got = flow_mod.flow_inference_batched(
        fm, tok_pad, [20], pf_pad, [12], emb[None], noise,
        streaming=streaming, device="cpu")[0, :40]
    want = checks.flow_latents(checks.flow_reference(model, state, CPU),
                               toks, pf, emb, streaming, CPU)
    assert checks.rel_err(got, want) < 1e-5


def test_vocoder_matches():
    from minimax_speech_torch.config import build_tts_config
    from minimax_speech_torch.infer.pipeline import TTSPipeline
    model = model_block()
    cfg = build_tts_config(program.tts_data(model))
    pipe = TTSPipeline(cfg, device="cpu")
    voc = pipe.models()["codec"]
    state = weights.make_state(voc, 13, CPU)
    voc.load_state_dict(state)
    feat = torch.randn(1, 24, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = pipe.decode(feat)
        want = checks.vocoder_reference(model, state, CPU)
        from speechbench.drivers.stream import vocode
        want = vocode(want, feat)
    assert checks.rel_err(got, want) < 1e-5


def test_training_loss_and_gradients_match():
    from minimax_speech_torch.config import build_tts_config
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.train import steps
    from speechbench.drivers import train
    model = model_block()
    cfg = build_tts_config(program.tts_data(model)).lm
    lm = llm_mod.SpeechLM(cfg)
    state = weights.make_state(lm, 14, CPU)
    lm.load_state_dict(state)
    mix = support.context("lm.train").traffic
    hb = next(train.batches(mix, 5, cfg, support.TINY["train"]))
    b = {k: torch.as_tensor(hb[k]) for k in train.TRUE_KEYS}
    loss, _ = steps.make_lm_loss_fn(lm)(b)
    grads = torch.autograd.grad(loss, list(lm.parameters()),
                                allow_unused=True)
    ref = ref_models.on(CPU, lambda: ref_llm.SpeechLM(
        ref_models.build_lm_config(model)))
    ref.load_state_dict(state)
    params = list(ref.parameters())
    ref_loss, ref_grads = train.blocked_grads(ref, params, hb, CPU, 64)
    assert abs(float(loss.detach()) - ref_loss) / ref_loss < 1e-6
    for g, rg in zip(grads, ref_grads):
        if g is not None and float(rg.norm()) > 0:
            assert checks.rel_err(g, rg) < 1e-4
