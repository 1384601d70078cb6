"""Converters of the upstream checkpoints' state dicts to the flax
variable trees that utils/params_io.py loads into the port's modules (and
the JAX package loads as they are):

  llm.pt   Qwen2LM -> SpeechLM (speech_lm_params)
  flow.pt  CausalMaskedDiffWithXvec -> FlowModel (flow_params)
  hift.pt  HiFTGenerator -> HiFTGenerator (hift_params)
  CosyVoice1 flow.pt  MaskedDiffWithXvec -> models/legacy_flow
           (legacy_flow_params)
  Matcha-TTS acoustic checkpoint -> models/matcha.TextEncoder
           (matcha_text_encoder_params)

Port of minimax_speech_tpu/utils/convert.py; the S3 tokenizer's, the
DAC-VAE's and Qwen2's converters live beside their models
(params_from_torch_state, params_from_hf_state). Numpy in and out: the
state dicts are {name: numpy array}, as cli/convert_checkpoint.py loads
them with torch.load; `campplus_params` also takes a campplus.onnx's
initializers (utils/onnx_reader.py). Matcha's HiFi-GAN converter lives
in models/matcha_hifigan.py.
"""
from __future__ import annotations

import numpy as np

from minimax_speech_torch.models import qwen2


def _dw(w):  # torch Linear (out, in) -> flax (in, out)
    return np.transpose(w, (1, 0))


def _conv(w):  # torch Conv1d (out, in, k) -> flax (k, in, out)
    return np.transpose(w, (2, 1, 0))


def strip_prefix(state: dict, prefixes=("module.",)) -> dict:
    out = {}
    for k, v in state.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# speaker encoder (shared by llm.pt and flow.pt)
# ---------------------------------------------------------------------------

def speaker_encoder_params(state: dict, prefix: str = "speaker_encoder.",
                           num_blocks: int = 6) -> dict:
    """LearnableSpeakerEncoder (reference: llm/llm.py:34-96 +
    transformer/arch_util.py AttentionBlock: norm/qkv/proj_out convs)."""
    p: dict = {}
    # init conv k=1: (C,80,1) -> Dense (80,C)
    p["init"] = {"kernel": state[prefix + "init.weight"][:, :, 0].T,
                 "bias": state[prefix + "init.bias"]}
    for i in range(num_blocks):
        ap = f"{prefix}attn.{i}."
        p[f"attn_{i}"] = {
            "norm": {"scale": state[ap + "norm.weight"],
                     "bias": state[ap + "norm.bias"]},
            "qkv": {"kernel": state[ap + "qkv.weight"][:, :, 0].T,
                    "bias": state[ap + "qkv.bias"]},
            "proj_out": {"kernel": state[ap + "proj_out.weight"][:, :, 0].T,
                         "bias": state[ap + "proj_out.bias"]},
        }
    p["output_proj"] = {"kernel": _dw(state[prefix + "output_proj.weight"]),
                        "bias": state[prefix + "output_proj.bias"]}
    return p


# ---------------------------------------------------------------------------
# llm.pt -> SpeechLM
# ---------------------------------------------------------------------------

def speech_lm_params(state: dict, cfg) -> dict:
    """Map a reference Qwen2LM state_dict to SpeechLM params.

    Reference names: llm.model.<hf qwen2 names>, llm_embedding.weight,
    speech_embedding.weight, llm_decoder.{weight,bias},
    spk_embed_affine_layer.{weight,bias}, speaker_encoder.*"""
    state = strip_prefix(state)
    hf_state = {k[len("llm.model."):]: v for k, v in state.items()
                if k.startswith("llm.model.")}
    qwen_params, embed, _ = qwen2.params_from_hf_state(hf_state, cfg.qwen)

    p = {"llm": qwen_params["params"],
         "text_embedding": {"embedding": embed},
         "llm_embedding": {"embedding": state["llm_embedding.weight"]},
         "speech_embedding": {"embedding": state["speech_embedding.weight"]},
         "llm_decoder": {"kernel": _dw(state["llm_decoder.weight"]),
                         "bias": state["llm_decoder.bias"]},
         "spk_embed_affine_layer": {
             "kernel": _dw(state["spk_embed_affine_layer.weight"]),
             "bias": state["spk_embed_affine_layer.bias"]}}
    if cfg.use_speaker_encoder and any(
            k.startswith("speaker_encoder.") for k in state):
        p["speaker_encoder"] = speaker_encoder_params(
            state, num_blocks=cfg.speaker.num_blocks)
    return {"params": p}


# ---------------------------------------------------------------------------
# flow.pt -> FlowModel
# ---------------------------------------------------------------------------

def _conformer_layer_params(state: dict, prefix: str) -> dict:
    """ConformerEncoderLayer with rel-pos attention and plain FFNs
    (reference: transformer/encoder_layer.py:109-158 + attention.py:200)."""
    sa = prefix + "self_attn."
    return {
        "norm_mha": {"scale": state[prefix + "norm_mha.weight"],
                     "bias": state[prefix + "norm_mha.bias"]},
        "norm_ff": {"scale": state[prefix + "norm_ff.weight"],
                    "bias": state[prefix + "norm_ff.bias"]},
        "self_attn": {
            "linear_q": {"kernel": _dw(state[sa + "linear_q.weight"]),
                         "bias": state[sa + "linear_q.bias"]},
            "linear_k": {"kernel": _dw(state[sa + "linear_k.weight"]),
                         "bias": state[sa + "linear_k.bias"]},
            "linear_v": {"kernel": _dw(state[sa + "linear_v.weight"]),
                         "bias": state[sa + "linear_v.bias"]},
            "linear_out": {"kernel": _dw(state[sa + "linear_out.weight"]),
                           "bias": state[sa + "linear_out.bias"]},
            "linear_pos": {"kernel": _dw(state[sa + "linear_pos.weight"])},
            "pos_bias_u": state[sa + "pos_bias_u"],
            "pos_bias_v": state[sa + "pos_bias_v"],
        },
        "feed_forward": {
            "w_1": {"kernel": _dw(state[prefix + "feed_forward.w_1.weight"]),
                    "bias": state[prefix + "feed_forward.w_1.bias"]},
            "w_2": {"kernel": _dw(state[prefix + "feed_forward.w_2.weight"]),
                    "bias": state[prefix + "feed_forward.w_2.bias"]},
        },
    }


def _unet_tf_block_params(state: dict, prefix: str) -> dict:
    """diffusers BasicTransformerBlock -> UNetTransformerBlock
    (reference: matcha/models/components/transformer.py:138-316)."""
    return {
        "norm1": {"scale": state[prefix + "norm1.weight"],
                  "bias": state[prefix + "norm1.bias"]},
        "norm3": {"scale": state[prefix + "norm3.weight"],
                  "bias": state[prefix + "norm3.bias"]},
        "to_q": {"kernel": _dw(state[prefix + "attn1.to_q.weight"])},
        "to_k": {"kernel": _dw(state[prefix + "attn1.to_k.weight"])},
        "to_v": {"kernel": _dw(state[prefix + "attn1.to_v.weight"])},
        "to_out": {"kernel": _dw(state[prefix + "attn1.to_out.0.weight"]),
                   "bias": state[prefix + "attn1.to_out.0.bias"]},
        "ff_in": {"kernel": _dw(state[prefix + "ff.net.0.proj.weight"]),
                  "bias": state[prefix + "ff.net.0.proj.bias"]},
        "ff_out": {"kernel": _dw(state[prefix + "ff.net.2.weight"]),
                   "bias": state[prefix + "ff.net.2.bias"]},
    }


def _causal_block_params(state: dict, prefix: str) -> dict:
    """CausalBlock1D: block.0 conv, block.2 LayerNorm
    (reference: flow/decoder.py:66-80)."""
    return {
        "conv": {"kernel": _conv(state[prefix + "block.0.weight"]),
                 "bias": state[prefix + "block.0.bias"]},
        "norm": {"scale": state[prefix + "block.2.weight"],
                 "bias": state[prefix + "block.2.bias"]},
    }


def _resnet_params(state: dict, prefix: str) -> dict:
    """CausalResnetBlock1D (reference: flow/decoder.py:83-88 + matcha
    ResnetBlock1D: mlp.1 linear, res_conv)."""
    return {
        "block1": _causal_block_params(state, prefix + "block1."),
        "block2": _causal_block_params(state, prefix + "block2."),
        "mlp": {"kernel": _dw(state[prefix + "mlp.1.weight"]),
                "bias": state[prefix + "mlp.1.bias"]},
        "res_conv": {"kernel": state[prefix + "res_conv.weight"][:, :, 0].T,
                     "bias": state[prefix + "res_conv.bias"]},
    }


def flow_params(state: dict, cfg) -> dict:
    """Map a reference CausalMaskedDiffWithXvec state_dict to FlowModel."""
    state = strip_prefix(state)
    p: dict = {}
    p["input_embedding"] = {"embedding": state["input_embedding.weight"]}
    p["spk_embed_affine_layer"] = {
        "kernel": _dw(state["spk_embed_affine_layer.weight"]),
        "bias": state["spk_embed_affine_layer.bias"]}
    p["encoder_proj"] = {"kernel": _dw(state["encoder_proj.weight"]),
                         "bias": state["encoder_proj.bias"]}

    enc: dict = {}
    e = "encoder."
    enc["embed"] = {
        "linear": {"kernel": _dw(state[e + "embed.out.0.weight"]),
                   "bias": state[e + "embed.out.0.bias"]},
        "norm": {"scale": state[e + "embed.out.1.weight"],
                 "bias": state[e + "embed.out.1.bias"]}}
    enc["up_embed"] = {
        "linear": {"kernel": _dw(state[e + "up_embed.out.0.weight"]),
                   "bias": state[e + "up_embed.out.0.bias"]},
        "norm": {"scale": state[e + "up_embed.out.1.weight"],
                 "bias": state[e + "up_embed.out.1.bias"]}}
    pre = e + "pre_lookahead_layer."
    enc["pre_lookahead_layer"] = {
        "conv1": {"kernel": _conv(state[pre + "conv1.weight"]),
                  "bias": state[pre + "conv1.bias"]},
        "conv2": {"kernel": _conv(state[pre + "conv2.weight"]),
                  "bias": state[pre + "conv2.bias"]}}
    enc["up_layer"] = {"conv": {
        "kernel": _conv(state[e + "up_layer.conv.weight"]),
        "bias": state[e + "up_layer.conv.bias"]}}
    for i in range(cfg.encoder.num_blocks):
        enc[f"encoders_{i}"] = _conformer_layer_params(
            state, f"{e}encoders.{i}.")
    for i in range(cfg.encoder.num_up_blocks):
        enc[f"up_encoders_{i}"] = _conformer_layer_params(
            state, f"{e}up_encoders.{i}.")
    enc["after_norm"] = {"scale": state[e + "after_norm.weight"],
                         "bias": state[e + "after_norm.bias"]}
    p["encoder"] = enc

    est: dict = {}
    d = "decoder.estimator."
    est["time_mlp"] = {
        "linear_1": {"kernel": _dw(state[d + "time_mlp.linear_1.weight"]),
                     "bias": state[d + "time_mlp.linear_1.bias"]},
        "linear_2": {"kernel": _dw(state[d + "time_mlp.linear_2.weight"]),
                     "bias": state[d + "time_mlp.linear_2.bias"]}}
    n_stages = len(cfg.unet.channels)
    for i in range(n_stages):
        pre = f"{d}down_blocks.{i}."
        est[f"down_{i}_resnet"] = _resnet_params(state, pre + "0.")
        for j in range(cfg.unet.n_blocks):
            est[f"down_{i}_tf_{j}"] = _unet_tf_block_params(
                state, pre + f"1.{j}.")
        est[f"down_{i}_conv"] = {
            "kernel": _conv(state[pre + "2.weight"]),
            "bias": state[pre + "2.bias"]}
    for i in range(cfg.unet.num_mid_blocks):
        pre = f"{d}mid_blocks.{i}."
        est[f"mid_{i}_resnet"] = _resnet_params(state, pre + "0.")
        for j in range(cfg.unet.n_blocks):
            est[f"mid_{i}_tf_{j}"] = _unet_tf_block_params(
                state, pre + f"1.{j}.")
    for i in range(n_stages):
        pre = f"{d}up_blocks.{i}."
        est[f"up_{i}_resnet"] = _resnet_params(state, pre + "0.")
        for j in range(cfg.unet.n_blocks):
            est[f"up_{i}_tf_{j}"] = _unet_tf_block_params(
                state, pre + f"1.{j}.")
        est[f"up_{i}_conv"] = {
            "kernel": _conv(state[pre + "2.weight"]),
            "bias": state[pre + "2.bias"]}
    est["final_block"] = _causal_block_params(state, d + "final_block.")
    est["final_proj"] = {
        "kernel": state[d + "final_proj.weight"][:, :, 0].T,
        "bias": state[d + "final_proj.bias"]}
    p["estimator"] = est

    if cfg.use_speaker_encoder and any(
            k.startswith("speaker_encoder.") for k in state):
        p["speaker_encoder"] = speaker_encoder_params(
            state, num_blocks=cfg.speaker.num_blocks)
    return {"params": p}


# ---------------------------------------------------------------------------
# hift.pt -> HiFTGenerator
# ---------------------------------------------------------------------------

def _wn_conv(state: dict, prefix: str) -> dict:
    """A weight-normed conv, plain or transposed: g flat, v (out, in, k)
    or (in, out, k) reversed to (k, in, out) or (k, out, in); weight_g /
    weight_v or their parametrizations names."""
    def k(suffix):
        for cand in (prefix + suffix,
                     prefix + suffix.replace(
                         "weight_g", "parametrizations.weight.original0"
                     ).replace("weight_v",
                               "parametrizations.weight.original1")):
            if cand in state:
                return state[cand]
        raise KeyError(prefix + suffix)

    g, v, b = k("weight_g"), k("weight_v"), state[prefix + "bias"]
    return {"g": g.reshape(-1), "v": np.transpose(v, (2, 1, 0)), "bias": b}


def _snake(state, name):
    a = state[name + ".alpha"]
    return {"alpha": a.reshape(1, 1, -1)}


def _resblock(state: dict, prefix: str, n: int) -> dict:
    p = {}
    for i in range(n):
        p[f"conv1_{i}"] = _wn_conv(state, f"{prefix}convs1.{i}.")
        p[f"conv2_{i}"] = _wn_conv(state, f"{prefix}convs2.{i}.")
        p[f"act1_{i}"] = _snake(state, f"{prefix}activations1.{i}")
        p[f"act2_{i}"] = _snake(state, f"{prefix}activations2.{i}")
    return p


def hift_params(state: dict, cfg) -> dict:
    """Map an upstream HiFTGenerator state dict to HiFTGenerator's tree
    (cfg: its HiFTConfig); the source downsamplers are plain convs."""
    state = strip_prefix(state)
    p: dict = {}
    p["conv_pre"] = _wn_conv(state, "conv_pre.")
    p["conv_post"] = _wn_conv(state, "conv_post.")
    p["source_linear"] = {"kernel": _dw(state["m_source.l_linear.weight"]),
                          "bias": state["m_source.l_linear.bias"]}
    for i in range(len(cfg.upsample_rates)):
        p[f"ups_{i}"] = _wn_conv(state, f"ups.{i}.")
        sd = {"kernel": _conv(state[f"source_downs.{i}.weight"]),
              "bias": state[f"source_downs.{i}.bias"]}
        p[f"source_downs_{i}"] = sd
        p[f"source_resblocks_{i}"] = _resblock(
            state, f"source_resblocks.{i}.",
            len(cfg.source_resblock_dilations[i]))
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates) * n_k):
        p[f"resblocks_{i}"] = _resblock(
            state, f"resblocks.{i}.",
            len(cfg.resblock_dilations[i % n_k]))
    fp = {}
    for i in range(5):
        fp[f"conv_{i}"] = _wn_conv(state, f"f0_predictor.condnet.{2 * i}.")
    fp["classifier"] = {"kernel": _dw(state["f0_predictor.classifier.weight"]),
                        "bias": state["f0_predictor.classifier.bias"]}
    p["f0_predictor"] = fp
    return {"params": p}


# ---------------------------------------------------------------------------
# campplus.onnx / campplus torch checkpoint -> models/campplus.py CAMPPlus
# ---------------------------------------------------------------------------

def _bn(state: dict, prefix: str) -> dict:
    """BatchNorm (torch) -> BNEval params; affine=False BNs (the
    'batchnorm_' config in D-TDNN) get identity gamma/beta."""
    mean = state[prefix + "running_mean"]
    var = state[prefix + "running_var"]
    gamma = state.get(prefix + "weight", np.ones_like(mean))
    beta = state.get(prefix + "bias", np.zeros_like(mean))
    return {"gamma": gamma, "beta": beta, "mean": mean, "var": var}


def _conv2(w):  # torch Conv2d (out, in, kh, kw) -> flax (kh, kw, in, out)
    return np.transpose(w, (2, 3, 1, 0))


def campplus_params(state: dict,
                    block_layers=(12, 24, 16)) -> dict:
    """CAM++ x-vector weights -> the flax tree of models/campplus.py
    CAMPPlus (both packages load it). `state` is a torch state dict (the
    3D-Speaker CAM++ release) or a campplus.onnx's initializers read by
    utils/onnx_reader.py."""
    state = strip_prefix(state)
    p: dict = {}

    def resblock(prefix):
        out = {"conv1": {"kernel": _conv2(state[prefix + "conv1.weight"])},
               "bn1": _bn(state, prefix + "bn1."),
               "conv2": {"kernel": _conv2(state[prefix + "conv2.weight"])},
               "bn2": _bn(state, prefix + "bn2.")}
        if prefix + "shortcut.0.weight" in state:
            out["shortcut_conv"] = {
                "kernel": _conv2(state[prefix + "shortcut.0.weight"])}
            out["shortcut_bn"] = _bn(state, prefix + "shortcut.1.")
        return out

    head = {"conv1": {"kernel": _conv2(state["head.conv1.weight"])},
            "bn1": _bn(state, "head.bn1."),
            "conv2": {"kernel": _conv2(state["head.conv2.weight"])},
            "bn2": _bn(state, "head.bn2.")}
    for li in (1, 2):
        for bi in (0, 1):
            head[f"layer{li}_{bi}"] = resblock(f"head.layer{li}.{bi}.")
    p["head"] = head

    p["tdnn_linear"] = {"kernel": _conv(state["xvector.tdnn.linear.weight"])}
    p["tdnn_bn"] = _bn(state, "xvector.tdnn.nonlinear.batchnorm.")

    for b, n_layers in enumerate(block_layers, start=1):
        for l in range(1, n_layers + 1):
            pref = f"xvector.block{b}.tdnnd{l}."
            cam = {
                "linear_local": {"kernel": _conv(
                    state[pref + "cam_layer.linear_local.weight"])},
                "linear1": {"kernel": _conv(
                    state[pref + "cam_layer.linear1.weight"]),
                    "bias": state[pref + "cam_layer.linear1.bias"]},
                "linear2": {"kernel": _conv(
                    state[pref + "cam_layer.linear2.weight"]),
                    "bias": state[pref + "cam_layer.linear2.bias"]},
            }
            p[f"block{b}_layer{l}"] = {
                "nonlinear1": _bn(state, pref + "nonlinear1.batchnorm."),
                "linear1": {"kernel": _conv(state[pref + "linear1.weight"])},
                "nonlinear2": _bn(state, pref + "nonlinear2.batchnorm."),
                "cam_layer": cam,
            }
        p[f"transit{b}_bn"] = _bn(
            state, f"xvector.transit{b}.nonlinear.batchnorm.")
        p[f"transit{b}_linear"] = {"kernel": _conv(
            state[f"xvector.transit{b}.linear.weight"])}

    p["out_bn"] = _bn(state, "xvector.out_nonlinear.batchnorm.")
    p["dense_linear"] = {
        "kernel": state["xvector.dense.linear.weight"][:, :, 0].T}
    p["dense_bn"] = _bn(state, "xvector.dense.nonlinear.batchnorm.")
    return {"params": p}


# ---------------------------------------------------------------------------
# Matcha-TTS text encoder
# ---------------------------------------------------------------------------

def matcha_text_encoder_params(state: dict, n_layers: int = 6,
                               prenet_layers: int = 3,
                               prefix: str = "encoder.") -> dict:
    """A released Matcha-TTS acoustic state dict -> models/matcha
    TextEncoder's subtree (keys 'encoder.emb.weight',
    'encoder.prenet.conv_layers.*', 'encoder.encoder.attn_layers.*',
    'encoder.proj_m.*', 'encoder.proj_w.*')."""
    def g(k):
        return np.asarray(state[prefix + k])

    def ln(k):
        return {"gamma": g(k + ".gamma"), "beta": g(k + ".beta")}

    def conv(k):
        return {"kernel": _conv(g(k + ".weight")), "bias": g(k + ".bias")}

    def dense1x1(k):  # torch Conv1d k=1 -> Dense
        return {"kernel": _dw(g(k + ".weight")[:, :, 0]),
                "bias": g(k + ".bias")}

    p = {"emb": {"embedding": g("emb.weight")}}
    pre = {"proj": dense1x1("prenet.proj")}
    for i in range(prenet_layers):
        pre[f"conv_{i}"] = conv(f"prenet.conv_layers.{i}")
        pre[f"norm_{i}"] = ln(f"prenet.norm_layers.{i}")
    p["prenet"] = pre
    for i in range(n_layers):
        p[f"attn_{i}"] = {
            f"conv_{nm}": dense1x1(f"encoder.attn_layers.{i}.conv_{nm}")
            for nm in ("q", "k", "v", "o")}
        p[f"norm1_{i}"] = ln(f"encoder.norm_layers_1.{i}")
        p[f"ffn_{i}"] = {
            "conv_1": conv(f"encoder.ffn_layers.{i}.conv_1"),
            "conv_2": conv(f"encoder.ffn_layers.{i}.conv_2")}
        p[f"norm2_{i}"] = ln(f"encoder.norm_layers_2.{i}")
    p["proj_m"] = dense1x1("proj_m")
    p["dp"] = {"conv_1": conv("proj_w.conv_1"),
               "norm_1": ln("proj_w.norm_1"),
               "conv_2": conv("proj_w.conv_2"),
               "norm_2": ln("proj_w.norm_2"),
               "proj": dense1x1("proj_w.proj")}
    return p


# ---------------------------------------------------------------------------
# CosyVoice1 flow.pt -> MaskedDiffWithXvec
# ---------------------------------------------------------------------------

def _noncausal_block_params(state: dict, prefix: str) -> dict:
    """Block1D: block.0 conv (k 3), block.1 GroupNorm."""
    return {
        "conv": {"kernel": _conv(state[prefix + "block.0.weight"]),
                 "bias": state[prefix + "block.0.bias"]},
        "norm": {"scale": state[prefix + "block.1.weight"],
                 "bias": state[prefix + "block.1.bias"]},
    }


def _noncausal_resnet_params(state: dict, prefix: str) -> dict:
    return {
        "block1": _noncausal_block_params(state, prefix + "block1."),
        "block2": _noncausal_block_params(state, prefix + "block2."),
        "mlp": {"kernel": _dw(state[prefix + "mlp.1.weight"]),
                "bias": state[prefix + "mlp.1.bias"]},
        "res_conv": {"kernel": state[prefix + "res_conv.weight"][:, :, 0].T,
                     "bias": state[prefix + "res_conv.bias"]},
    }


def legacy_flow_params(state: dict, cfg) -> dict:
    """An upstream MaskedDiffWithXvec state dict (cfg: its
    LegacyFlowConfig) -> models/legacy_flow's tree: the plain conformer
    encoder, the regulator, and the non-causal UNet, whose Downsample1D
    and Upsample1D wrap their convs in `.conv`."""
    state = strip_prefix(state)
    p: dict = {}
    p["input_embedding"] = {"embedding": state["input_embedding.weight"]}
    p["spk_embed_affine_layer"] = {
        "kernel": _dw(state["spk_embed_affine_layer.weight"]),
        "bias": state["spk_embed_affine_layer.bias"]}
    p["encoder_proj"] = {"kernel": _dw(state["encoder_proj.weight"]),
                         "bias": state["encoder_proj.bias"]}

    e = "encoder."
    enc: dict = {
        "embed_linear": {"kernel": _dw(state[e + "embed.out.0.weight"]),
                         "bias": state[e + "embed.out.0.bias"]},
        "embed_norm": {"scale": state[e + "embed.out.1.weight"],
                       "bias": state[e + "embed.out.1.bias"]}}
    for i in range(cfg.encoder.num_blocks):
        enc[f"layers_{i}"] = _conformer_layer_params(
            state, f"{e}encoders.{i}.")
    enc["after_norm"] = {"scale": state[e + "after_norm.weight"],
                         "bias": state[e + "after_norm.bias"]}
    p["encoder"] = enc

    reg: dict = {}
    n_stages = len(cfg.regulator_ratios)
    r = "length_regulator.model."
    for i in range(n_stages):
        reg[f"conv_{i}"] = {"kernel": _conv(state[f"{r}{3 * i}.weight"]),
                            "bias": state[f"{r}{3 * i}.bias"]}
        reg[f"norm_{i}"] = {"scale": state[f"{r}{3 * i + 1}.weight"],
                            "bias": state[f"{r}{3 * i + 1}.bias"]}
    reg["out_proj"] = {
        "kernel": state[f"{r}{3 * n_stages}.weight"][:, :, 0].T,
        "bias": state[f"{r}{3 * n_stages}.bias"]}
    p["length_regulator"] = reg

    d = "decoder.estimator."
    est: dict = {"time_mlp": {
        name: {"kernel": _dw(state[f"{d}time_mlp.{name}.weight"]),
               "bias": state[f"{d}time_mlp.{name}.bias"]}
        for name in ("linear_1", "linear_2")}}

    def stage(name: str, pre: str):
        est[f"{name}_resnet"] = _noncausal_resnet_params(state, pre + "0.")
        for j in range(cfg.unet.n_blocks):
            est[f"{name}_tf_{j}"] = _unet_tf_block_params(
                state, pre + f"1.{j}.")

    def conv_at(pre: str, wrapped: bool, transposed: bool = False):
        key = pre + ("2.conv." if wrapped else "2.")
        w = state[key + "weight"]
        # ConvTranspose1d (in, out, k) -> (k, out, in); Conv1d -> (k, in, out)
        return {"kernel": w.transpose(2, 1, 0) if transposed else _conv(w),
                "bias": state[key + "bias"]}

    n = len(cfg.unet.channels)
    for i in range(n):
        pre = f"{d}down_blocks.{i}."
        stage(f"down_{i}", pre)
        est[f"down_{i}_conv"] = conv_at(pre, wrapped=i != n - 1)
    for i in range(cfg.unet.num_mid_blocks):
        stage(f"mid_{i}", f"{d}mid_blocks.{i}.")
    for i in range(n):
        pre = f"{d}up_blocks.{i}."
        stage(f"up_{i}", pre)
        est[f"up_{i}_conv"] = conv_at(pre, wrapped=i != n - 1,
                                      transposed=i != n - 1)
    est["final_block"] = _noncausal_block_params(state, d + "final_block.")
    est["final_proj"] = {
        "kernel": state[d + "final_proj.weight"][:, :, 0].T,
        "bias": state[d + "final_proj.bias"]}
    p["estimator"] = est
    return {"params": p}
