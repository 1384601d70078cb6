"""CAM++ x-vector conditioning of the port against the JAX package.

CPU, float32. The weights are a random state dict of the public CAM++
graph (the torch replica of tests/test_campplus.py, batch-norm statistics
randomised), converted by both packages' `campplus_params`, or the same
dict written as a campplus.onnx by chip_smoke.write_onnx and read back by
the port's pure-Python reader. Limits:
- the kaldi fbank: within 2e-4 (log of a float32 power spectrum: the
  rFFT's rounding, relative 2e-4 of the power);
- each CAM++ block and the whole embedding: within 1e-5 of the largest
  JAX output (float32 sums in other orders; measured 4e-7);
- TTS: the x-vector, and add_zero_shot_spk's lm_spk and flow_emb,
  within 1e-5 of the largest JAX value;
- the converters and the ONNX reader: exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from minimax_speech_torch.cli import convert_checkpoint as t_convert_cli
from minimax_speech_torch.cli import extract_embedding as t_emb
from minimax_speech_torch.infer import api as t_api
from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.models import campplus as t_cp
from minimax_speech_torch.ops.kaldi_fbank import kaldi_fbank as t_fbank
from minimax_speech_torch.utils import convert as t_conv
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_torch.utils.onnx_reader import read_onnx_initializers
from minimax_speech_tpu.cli import convert_checkpoint as j_convert_cli
from minimax_speech_tpu.cli import extract_embedding as j_emb
from minimax_speech_tpu.infer import api as j_api
from minimax_speech_tpu.infer import pipeline as j_pl
from minimax_speech_tpu.models import campplus as j_cp
from minimax_speech_tpu.ops.kaldi_fbank import kaldi_fbank as j_fbank
from minimax_speech_tpu.utils import convert as j_conv
from minimax_speech_tpu.utils import params_io as j_io
from tests.conftest import synthetic_audio
from tests.test_campplus import TorchCAMPPlus, _randomize_bn
from tests.test_torch_bridge import jitter, port_config, tiny_cfg
from tests.test_torch_extract import write_wav
from tests import torch_cpu

torch_cpu.share_cores()

SMALL = dict(feat_dim=16, embedding_size=12, growth_rate=8, bn_size=2,
             init_channels=16, m_channels=8, block_layers=(2, 2),
             block_dilations=(1, 2), seg_len=5)
EMB_RTOL = 1e-5


def _close(ours, ref, rtol=EMB_RTOL, msg=""):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, msg
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max(), err_msg=msg)


def _state(geometry, seed):
    torch.manual_seed(seed)
    ref = TorchCAMPPlus(*geometry)
    with torch.no_grad():
        _randomize_bn(ref, np.random.default_rng(seed))
    return ref.eval(), {k: v.detach().numpy()
                        for k, v in ref.state_dict().items()}


@pytest.fixture(scope="module")
def small():
    """(replica, state dict, the JAX converter's tree, the JAX and port
    configs) at a test geometry."""
    ref, state = _state((16, 12, 8, 2, 16, 8, (2, 2), (1, 2)), 0)
    jcfg = j_cp.CAMPPlusConfig(**SMALL)
    return ref, state, j_conv.campplus_params(state, block_layers=(2, 2)), \
        jcfg, t_cp.CAMPPlusConfig(**SMALL)


@pytest.fixture(scope="module")
def full_onnx(tmp_path_factory):
    """The default CAM++ geometry's random weights as a campplus.onnx."""
    _, state = _state((80, 192, 32, 4, 128, 32, (12, 24, 16), (1, 2, 2)), 1)
    path = tmp_path_factory.mktemp("campplus") / "campplus.onnx"
    return chip_smoke.write_onnx(path, state), state


@pytest.mark.parametrize("seconds", [0.02, 1.0, 3.37])
def test_kaldi_fbank_matches(seconds):
    """Shorter than a window (no frames), one second, a ragged length."""
    audio = synthetic_audio(np.random.default_rng(3), seconds, 16000)
    ref = np.asarray(j_fbank(jnp.asarray(audio)))
    ours = t_fbank(torch.as_tensor(audio)).numpy()
    assert ours.shape == ref.shape == (max(1 + (len(audio) - 400) // 160, 0),
                                       80)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-4)


def test_converter_and_onnx_reader_are_exact(small, tmp_path):
    """The port's campplus_params gives the JAX converter's tree; the
    state written as .onnx reads back bit-identical in both readers."""
    _, state, tree, _, _ = small
    ours = t_io._flatten(t_conv.campplus_params(state, block_layers=(2, 2)))
    ref = t_io._flatten(tree)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=str(k))
    from minimax_speech_tpu.utils.onnx_reader import \
        read_onnx_initializers as j_read
    path = chip_smoke.write_onnx(tmp_path / "cp.onnx", state)
    back, jback = read_onnx_initializers(str(path)), j_read(str(path))
    assert back.keys() == jback.keys() == state.keys()
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(jback[k], v)


def _block_cases(jcfg):
    """(name, JAX module, port module, params path, JAX input shape, the
    permutation that gives the port's input)."""
    g, bn = jcfg.growth_rate, jcfg.bn_size * jcfg.growth_rate
    m = jcfg.m_channels
    return [
        ("bn", j_cp.BNEval(), t_cp.BNEval(16), ("tdnn_bn",), (2, 23, 16),
         (0, 2, 1)),
        ("resblock_stride2", j_cp.BasicResBlock(m, stride=2),
         t_cp.BasicResBlock(m, m, 2), ("head", "layer1_0"), (2, 16, 23, m),
         (0, 3, 1, 2)),
        ("resblock", j_cp.BasicResBlock(m), t_cp.BasicResBlock(m, m),
         ("head", "layer1_1"), (2, 8, 23, m), (0, 3, 1, 2)),
        ("fcm", j_cp.FCM(jcfg), t_cp.FCM(t_cp.CAMPPlusConfig(**SMALL)),
         ("head",), (2, 23, 16), (0, 1, 2)),
        ("cam_layer", j_cp.CAMLayer(bn, g, 3, 2, jcfg.seg_len),
         t_cp.CAMLayer(bn, g, 3, 2, jcfg.seg_len),
         ("block2_layer2", "cam_layer"), (2, 23, bn), (0, 2, 1)),
        ("dense_layer", j_cp.CAMDenseTDNNLayer(g, bn, 3, 2, jcfg.seg_len),
         t_cp.CAMDenseTDNNLayer(16, g, bn, 3, 2, jcfg.seg_len),
         ("block2_layer1",), (2, 23, 16), (0, 2, 1)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_blocks_match_jax(small, case):
    """Each block on the converter's weights; T = 23 leaves the CAM
    layer's last segment of 5 three frames long."""
    _, _, tree, jcfg, _ = small
    name, jmod, tmod, path, shape, axes = _block_cases(jcfg)[case]
    params = tree["params"]
    for p in path:
        params = params[p]
    x = np.random.default_rng(case).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    t_io.load_flax_params(tmod, params)
    with torch.no_grad():
        ours = tmod(torch.as_tensor(x).permute(*axes)).numpy()
    # channels first: (B, C, F, T) against (B, F, T, C), (B, C, T)
    # against (B, T, C)
    _close(ours.transpose((0, 2, 3, 1) if ours.ndim == 4 else (0, 2, 1)),
           ref, msg=name)


@pytest.mark.parametrize("source", ["state_dict", "onnx"])
def test_embedding_matches_jax_and_the_replica(small, source, tmp_path):
    """The whole embedding from the converted state dict and from the
    hand-written ONNX against JAX's CAMPPlus; the replica too (JAX's own
    limit, 2e-4 + 1e-3 relative)."""
    ref_model, state, tree, jcfg, tcfg = small
    if source == "onnx":
        state = t_cp.read_campplus_state(
            chip_smoke.write_onnx(tmp_path / "cp.onnx", state))
    model = t_io.load_flax_params(
        t_cp.CAMPPlus(tcfg), t_conv.campplus_params(state,
                                                   block_layers=(2, 2)))
    feat = np.random.default_rng(7).standard_normal((2, 23, 16)) \
        .astype(np.float32)
    ref = np.asarray(j_cp.CAMPPlus(jcfg).apply(tree, jnp.asarray(feat)))
    with torch.no_grad():
        ours = model.eval()(torch.as_tensor(feat))
        replica = ref_model(torch.as_tensor(feat)).numpy()
    _close(ours, ref)
    np.testing.assert_allclose(ours.numpy(), replica, atol=2e-4, rtol=1e-3)


def _xvector_cfg():
    """The tiny pipeline with the flow's speaker encoder off and 192-d
    speaker inputs (CAM++'s), as JAX's TTS takes x-vectors."""
    jcfg = tiny_cfg()
    jcfg = dataclasses.replace(
        jcfg, lm=dataclasses.replace(jcfg.lm, spk_embed_dim=192),
        flow=dataclasses.replace(jcfg.flow, spk_embed_dim=192,
                                 use_speaker_encoder=False))
    return jcfg, port_config(jcfg, t_pl.TTSConfig)


def test_tts_xvector_conditioning_matches_jax(full_onnx, tmp_path):
    """TTS(campplus=...) and a campplus.onnx found in a model_dir:
    xvector() and add_zero_shot_spk's lm_spk and flow_emb against JAX's
    TTS on the same weights and prompt; the flow_emb unit-norm."""
    path, _ = full_onnx
    jcfg, pcfg = _xvector_cfg()
    seed_pipe = t_pl.TTSPipeline.from_random(pcfg, seed=4, device="cpu")
    trees = {n: jitter(t_io.to_flax_params(m), seed=i)
             for i, (n, m) in enumerate(seed_pipe.models().items())}
    ref_tts = j_api.TTS(pipeline=j_pl.TTSPipeline(
        jcfg, trees["lm"], trees["flow"], trees["codec"], trees["s3"]),
        campplus=str(path))
    d = tmp_path / "model"
    d.mkdir()
    for n, tree in trees.items():
        t_io.save_tree(str(d / f"{'llm' if n == 'lm' else n}.npz"), tree)
    (d / "campplus.onnx").write_bytes(path.read_bytes())
    (d / "config.yaml").write_text(
        f"__base__: {chip_smoke.Path('configs/tiny.yaml').resolve()}\n"
        "model:\n  lm:\n    spk_embed_dim: 192\n    qwen:\n"
        "      vocab_size: 256\n  flow:\n    spk_embed_dim: 192\n"
        "    use_speaker_encoder: false\n")
    prompt = synthetic_audio(np.random.default_rng(5), 1.3, 16000)
    ref_xv = ref_tts.xvector(prompt)
    ref_tts.add_zero_shot_spk("reference", prompt, "a")
    for tts in (t_api.TTS(pipeline=t_pl.TTSPipeline.from_flax(
            pcfg, trees["lm"], trees["flow"], trees["codec"], trees["s3"],
            device="cpu"), campplus=str(path)),
            t_api.TTS(model_dir=str(d), device="cpu")):
        _close(tts.xvector(prompt), ref_xv)
        tts.add_zero_shot_spk("reference", prompt, "a")
        for k in ("lm_spk", "flow_emb"):
            _close(np.asarray(tts.spk2info["a"][k]),
                   ref_tts.spk2info["a"][k], msg=k)
        np.testing.assert_allclose(
            np.linalg.norm(tts.spk2info["a"]["flow_emb"]), 1.0, rtol=1e-6)


def test_extract_embedding_campplus_matches_jax(full_onnx, tmp_path):
    """--campplus from the .onnx and from a torch state dict, over wavs at
    16 and 24 kHz (resampled): x-vectors within 1e-5 of JAX's CLI's."""
    path, state = full_onnx
    pt = tmp_path / "campplus.pt"
    torch.save({k: torch.as_tensor(v) for k, v in state.items()}, pt)
    rng = np.random.default_rng(6)
    dirs = [tmp_path / n for n in ("j", "p_onnx", "p_pt")]
    for d in dirs:
        d.mkdir()
        rng = np.random.default_rng(6)
        for i, (sec, sr) in enumerate(((1.1, 16000), (0.9, 24000))):
            write_wav(d / f"c{i}.wav", synthetic_audio(rng, sec, sr), sr)
    j_emb.main(["--dir", str(dirs[0]), "--campplus", str(path)])
    t_emb.main(["--dir", str(dirs[1]), "--campplus", str(path),
                "--device", "cpu"])
    t_emb.main(["--dir", str(dirs[2]), "--campplus", str(pt),
                "--device", "cpu"])
    for i in range(2):
        ref = np.load(dirs[0] / f"c{i}_spk.npy")
        assert ref.shape == (192,)
        for d in dirs[1:]:
            _close(np.load(d / f"c{i}_spk.npy"), ref, msg=str(d))


@pytest.mark.parametrize("src", ["onnx", "pt"])
def test_convert_checkpoint_campplus_matches_jax(full_onnx, tmp_path, src):
    """--kind campplus from the .onnx or a torch state dict: the same
    .npz as JAX's CLI writes, loadable into the port's CAMPPlus."""
    path, state = full_onnx
    if src == "pt":
        path = tmp_path / "campplus.pt"
        torch.save({k: torch.as_tensor(v) for k, v in state.items()}, path)
    args = ["--kind", "campplus", "--src", str(path), "--config",
            "configs/tiny.yaml"]
    t_convert_cli.main(args + ["--out", str(tmp_path / "t.npz")])
    j_convert_cli.main(args + ["--out", str(tmp_path / "j.npz")])
    ours, ref = t_io.load_params(str(tmp_path / "t.npz")), \
        j_io.load_params(str(tmp_path / "j.npz"))
    ours, ref = t_io._flatten(ours), t_io._flatten(ref)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=str(k))
    t_io.load_flax_params(t_cp.CAMPPlus(), t_io.load_params(
        str(tmp_path / "t.npz")))
