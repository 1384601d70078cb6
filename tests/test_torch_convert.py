"""The port's checkpoint converters (utils/convert.py, the three
params_from_*_state functions, models/matcha_hifigan.py's,
cli/convert_checkpoint.py) against the JAX package's.

CPU. Random state dicts in the upstream key layouts at small widths, at
tests/test_convert.py's configs: llm (its helpers), dac, s3 and qwen
built here, flow and hift by chip_smoke.py's builders, which phase 27
runs at full width; matcha and matcha_hifigan by test_torch_matcha.py's,
at the default widths the CLI converts. The port's variable trees must
equal JAX's exactly, path for path and element for element, and load
into the port's modules. cli/convert_checkpoint.main
turns torch.save files into .npz files that both packages load, and a
HiFT from the converted hift state dict gives JAX's waveform.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.cli import convert_checkpoint as t_cli
from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.models import dac_vae as t_dac
from minimax_speech_torch.models import hifigan as t_h
from minimax_speech_torch.models import s3tokenizer as t_s3
from minimax_speech_torch.models.flow import FlowModel
from minimax_speech_torch.models.llm import SpeechLM
from minimax_speech_torch.models.matcha import MatchaConfig, TextEncoder
from minimax_speech_torch.models.matcha_hifigan import (MatchaHiFiGAN,
                                                        MatchaHiFiGANConfig)
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import dac_vae as j_dac
from minimax_speech_tpu.models import hifigan as j_h
from minimax_speech_tpu.models import matcha_hifigan as j_voc
from minimax_speech_tpu.models import qwen2 as j_qwen2
from minimax_speech_tpu.models import s3tokenizer as j_s3
from minimax_speech_tpu.utils import convert as j_conv
from minimax_speech_tpu.utils import params_io as j_io
import chip_smoke
from tests.test_convert import FLOW_CFG, HIFT_CFG, LM_CFG, arr, speaker_sd
from tests.test_torch_bridge import port_config
from tests.test_torch_matcha import hifigan_state, text_encoder_state
from tests import torch_cpu

torch_cpu.share_cores()

DAC_CFG = j_dac.DACVAEConfig(encoder_dim=4, encoder_rates=(2, 3),
                             latent_dim=8, decoder_dim=16,
                             decoder_rates=(3, 2))
S3_CFG = j_s3.S3TokenizerConfig(n_mels=16, n_state=32, n_head=4, n_layer=2,
                                fsmn_kernel=7)


def qwen_sd(q, prefix):
    sd = {prefix + "embed_tokens.weight": arr(q.vocab_size, q.hidden_size),
          prefix + "norm.weight": arr(q.hidden_size)}
    h, kv = q.n_heads * q.head_dim, q.n_kv_heads * q.head_dim
    for i in range(q.n_layers):
        L = f"{prefix}layers.{i}."
        sd |= {L + "input_layernorm.weight": arr(q.hidden_size),
               L + "post_attention_layernorm.weight": arr(q.hidden_size),
               L + "self_attn.q_proj.weight": arr(h, q.hidden_size),
               L + "self_attn.q_proj.bias": arr(h),
               L + "self_attn.k_proj.weight": arr(kv, q.hidden_size),
               L + "self_attn.k_proj.bias": arr(kv),
               L + "self_attn.v_proj.weight": arr(kv, q.hidden_size),
               L + "self_attn.v_proj.bias": arr(kv),
               L + "self_attn.o_proj.weight": arr(q.hidden_size, h),
               L + "mlp.gate_proj.weight": arr(q.intermediate_size,
                                               q.hidden_size),
               L + "mlp.up_proj.weight": arr(q.intermediate_size,
                                             q.hidden_size),
               L + "mlp.down_proj.weight": arr(q.hidden_size,
                                               q.intermediate_size)}
    return sd


def llm_sd():
    """The layout of tests/test_convert.py's llm case (a "module."
    prefix on every key, as a DDP checkpoint has)."""
    c = LM_CFG
    v = c.speech_token_size + 3
    sd = {"llm_embedding.weight": arr(2, 32),
          "speech_embedding.weight": arr(v, 32),
          "llm_decoder.weight": arr(v, 32), "llm_decoder.bias": arr(v),
          "spk_embed_affine_layer.weight": arr(32, 12),
          "spk_embed_affine_layer.bias": arr(32)}
    sd |= speaker_sd("speaker_encoder.", 8, 16, 12, 1)
    sd |= qwen_sd(c.qwen, "llm.model.model.")
    return {"module." + k: a for k, a in sd.items()}


def dac_sd(c=DAC_CFG):
    """An upstream DACVAE generator state dict for `c` (Sequential block
    indices; the decoder's weight norms under the parametrizations
    names)."""
    sd = {}

    def wn(prefix, out, inp, k, transpose=False, param=False):
        g, v = ((".parametrizations.weight.original0",
                 ".parametrizations.weight.original1") if param
                else (".weight_g", ".weight_v"))
        shape = (inp, out, k) if transpose else (out, inp, k)
        sd.update({prefix + g: arr(shape[0], 1, 1) + 1.0,
                   prefix + v: arr(*shape), prefix + ".bias": arr(out)})

    def snake(prefix, ch):
        sd[prefix + ".alpha"] = arr(1, ch, 1) + 1.0

    def res(prefix, ch, param):
        snake(prefix + ".block.0", ch)
        wn(prefix + ".block.1", ch, ch, 7, param=param)
        snake(prefix + ".block.2", ch)
        wn(prefix + ".block.3", ch, ch, 1, param=param)

    d = c.encoder_dim
    wn("encoder.block.0", d, c.d_in, 7)
    for i, s in enumerate(c.encoder_rates):
        tp = f"encoder.block.{i + 1}"
        for j in range(3):
            res(f"{tp}.block.{j}", d, False)
        snake(f"{tp}.block.3", d)
        wn(f"{tp}.block.4", 2 * d, d, 2 * s)
        d *= 2
    n = len(c.encoder_rates) + 1
    snake(f"encoder.block.{n}", d)
    wn(f"encoder.block.{n + 1}", c.latent_dim, d, 3)
    dim = c.decoder_dim
    wn("decoder.model.0", dim, c.latent_dim, 7, param=True)
    for i, s in enumerate(c.decoder_rates):
        tp = f"decoder.model.{i + 1}"
        snake(f"{tp}.block.0", dim)
        wn(f"{tp}.block.1", dim // 2, dim, 2 * s, transpose=True, param=True)
        for j in range(3):
            res(f"{tp}.block.{j + 2}", dim // 2, True)
        dim //= 2
    n = len(c.decoder_rates) + 1
    snake(f"decoder.model.{n}", dim)
    wn(f"decoder.model.{n + 1}", c.d_out, dim, 7, param=True)
    wn("en_conv_post", 2 * c.latent_dim, c.latent_dim, 1)
    wn("de_conv_pre", c.latent_dim, c.latent_dim, 1)
    return {"generator." + k: a for k, a in sd.items()}


def s3_sd(c=S3_CFG):
    n = c.n_state
    sd = {"encoder.conv1.weight": arr(n, c.n_mels, 3),
          "encoder.conv1.bias": arr(n),
          "encoder.conv2.weight": arr(n, n, 3), "encoder.conv2.bias": arr(n),
          "quantizer._codebook.project_down.weight": arr(8, n),
          "quantizer._codebook.project_down.bias": arr(8)}
    for i in range(c.n_layer):
        p = f"encoder.blocks.{i}."
        sd |= {p + "attn_ln.weight": arr(n), p + "attn_ln.bias": arr(n),
               p + "mlp_ln.weight": arr(n), p + "mlp_ln.bias": arr(n),
               p + "mlp.0.weight": arr(4 * n, n),
               p + "mlp.0.bias": arr(4 * n),
               p + "mlp.2.weight": arr(n, 4 * n), p + "mlp.2.bias": arr(n),
               p + "attn.query.weight": arr(n, n),
               p + "attn.query.bias": arr(n),
               p + "attn.key.weight": arr(n, n),
               p + "attn.value.weight": arr(n, n),
               p + "attn.value.bias": arr(n),
               p + "attn.out.weight": arr(n, n), p + "attn.out.bias": arr(n),
               p + "attn.fsmn_block.weight": arr(n, 1, c.fsmn_kernel)}
    return sd


def _jax_dac(sd):
    state = {k[len("generator."):]: a for k, a in sd.items()}
    return j_dac.params_from_torch_state(state, DAC_CFG)


def _jax_qwen(sd):
    params, embed, _ = j_qwen2.params_from_hf_state(sd, LM_CFG.qwen)
    return {"params": {"llm": params["params"],
                       "text_embedding": {"embedding": embed}}}


def _port_cfg():
    """A port TTSConfig whose sections are the small configs above."""
    return t_pl.TTSConfig(
        lm=port_config(LM_CFG, t_pl.TTSConfig().lm.__class__),
        flow=port_config(FLOW_CFG, t_pl.TTSConfig().flow.__class__),
        dac=port_config(DAC_CFG, t_dac.DACVAEConfig),
        hift=port_config(HIFT_CFG, t_h.HiFTConfig))


# kind: (state dict builder, JAX converter, the port module it loads into)
KINDS = {
    "llm": (llm_sd, lambda sd: j_conv.speech_lm_params(sd, LM_CFG),
            lambda cfg: SpeechLM(cfg.lm)),
    "flow": (lambda: chip_smoke.upstream_flow_state(_port_cfg().flow, 0),
             lambda sd: j_conv.flow_params(sd, FLOW_CFG),
             lambda cfg: FlowModel(cfg.flow)),
    "hift": (lambda: chip_smoke.upstream_hift_state(_port_cfg().hift, 0),
             lambda sd: j_conv.hift_params(sd, HIFT_CFG),
             lambda cfg: t_h.HiFTGenerator(cfg.hift)),
    "dac": (dac_sd, _jax_dac, lambda cfg: t_dac.DACVAE(cfg.dac)),
    "s3": (s3_sd, j_s3.params_from_torch_state,
           lambda cfg: t_s3.S3TokenizerV2(port_config(
               S3_CFG, t_s3.S3TokenizerConfig))),
    "qwen": (lambda: qwen_sd(LM_CFG.qwen, "model."), _jax_qwen,
             lambda cfg: SpeechLM(cfg.lm).llm),
    "matcha": (lambda: text_encoder_state(MatchaConfig(),
                                          np.random.default_rng(0)),
               lambda sd: {"params": j_conv.matcha_text_encoder_params(sd)},
               lambda cfg: TextEncoder(MatchaConfig())),
    "matcha_hifigan": (lambda: hifigan_state(MatchaHiFiGANConfig(),
                                             np.random.default_rng(1)),
                       j_voc.matcha_hifigan_params,
                       lambda cfg: MatchaHiFiGAN()),
}


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", list(KINDS))
def test_converter_gives_jax_tree(kind):
    build, jax_convert, module = KINDS[kind]
    sd = build()
    ours = flat(t_cli.convert(kind, sd, _port_cfg()))
    theirs = flat(jax_convert(sd))
    assert ours.keys() == theirs.keys() and len(ours) > 10
    for path, a in theirs.items():
        assert ours[path].dtype == a.dtype, path
        np.testing.assert_array_equal(ours[path], a, err_msg=path)
    tree = t_cli.convert(kind, sd, _port_cfg())
    if kind == "qwen":  # the LM body; the embedding table beside it
        tree = {"params": tree["params"]["llm"]}
    t_io.load_flax_params(module(_port_cfg()), tree)


def test_not_ported_kinds_raise(tmp_path):
    """No kind of the JAX CLI is left unported (matcha and matcha_hifigan
    were the last, tested above), and a kind the CLI does not know is
    refused."""
    assert set(t_cli.KINDS) == set(KINDS) | {"campplus"}
    with pytest.raises(SystemExit):
        t_cli.main(["--kind", "flowae", "--src", str(tmp_path / "x.pt"),
                    "--out", str(tmp_path / "x.npz")])


@pytest.mark.parametrize("kind", ["hift", "flow"])
def test_cli_npz_loads_in_both_packages(kind, tmp_path):
    """torch.save of the state dict (tensors, under "state_dict" for
    hift), the CLI, then the .npz read by both packages' loaders: the
    same tree as the converter's; for hift, the port's HiFT from it gives
    the JAX HiFT's waveform on the same file (float32 sums in other
    orders; the 6-frame source's cumsum is exact to 1e-7 here)."""
    sd = KINDS[kind][0]()
    tensors = {k: torch.as_tensor(a) for k, a in sd.items()}
    src = tmp_path / f"{kind}.pt"
    torch.save({"state_dict": tensors} if kind == "hift" else tensors, src)
    out = tmp_path / f"{kind}.npz"
    cfg = _port_cfg()
    yaml_cfg = tmp_path / "config.yaml"
    yaml_cfg.write_text(json.dumps({"model": {
        "flow": dataclasses.asdict(cfg.flow),
        "hift": dataclasses.asdict(cfg.hift)}}))  # JSON is YAML
    t_cli.main(["--kind", kind, "--src", str(src), "--out", str(out),
                "--config", str(yaml_cfg)])
    expect = flat(KINDS[kind][1](sd))
    for tree in (t_io.load_params(str(out)), j_io.load_params(str(out))):
        got = flat(tree)
        assert got.keys() == expect.keys()
        for path, a in expect.items():
            np.testing.assert_array_equal(got[path], a, err_msg=path)
    if kind != "hift":
        return
    tree = j_io.load_params(str(out))
    port = t_io.load_flax_params(
        t_h.HiFTGenerator(port_config(HIFT_CFG, t_h.HiFTConfig)).eval(),
        t_io.load_params(str(out)))
    mel = np.random.default_rng(0).standard_normal((1, 6, 8)).astype(
        np.float32)
    wav_j, _ = jax.jit(j_h.HiFTGenerator(HIFT_CFG).apply)(tree,
                                                          jnp.asarray(mel))
    with torch.no_grad():
        f0 = port.predict_f0(torch.as_tensor(mel))
        wav_t, _ = port(torch.as_tensor(mel))
    assert float((f0 > HIFT_CFG.nsf_voiced_threshold).float().mean()) >= 0.5
    assert wav_t.shape == (1, 6 * HIFT_CFG.total_upsample)
    np.testing.assert_allclose(wav_t.numpy(), np.asarray(wav_j), atol=1e-5)
