"""The port's zero-shot synthesis against the JAX package's, end to end.

CPU, float32, tiny geometry of tests/test_pipeline.py. The weights are
drawn once (the port's seeded init, then jittered), written as flax
trees and loaded by both packages. Both get the same prompt, text and
decode noise (JAX's own tables, as its generate draws them), so the
token count must be identical and the int16 PCM must agree to 2 LSB
(float32 sums in other orders through LM, 2 Euler steps and the codec).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch import config as t_config
from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu import config as j_config
from minimax_speech_tpu.infer import pipeline as j_pl
from minimax_speech_tpu.utils import params_io as j_io
from tests.conftest import synthetic_audio
from tests.test_torch_bridge import jitter, tiny_port_cfg
from tests.test_torch_lm import jax_decode_noise
from tests import torch_cpu

torch_cpu.share_cores()

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def trees():
    _, pcfg = tiny_port_cfg()
    seed_pipe = t_pl.TTSPipeline.from_random(pcfg, seed=3, device="cpu")
    return {name: jitter(t_io.to_flax_params(m), seed=i)
            for i, (name, m) in enumerate(seed_pipe.models().items())}


def test_synthesize_fused_matches_jax(trees, rng):
    jcfg, pcfg = tiny_port_cfg()
    port = t_pl.TTSPipeline.from_flax(pcfg, trees["lm"], trees["flow"],
                                      trees["codec"], trees["s3"],
                                      device="cpu")
    ref = j_pl.TTSPipeline(jcfg, trees["lm"], trees["flow"], trees["codec"])

    prompt_24k = synthetic_audio(rng, 0.6, 24000)
    prompt_tokens = rng.integers(0, 6561, 15)
    prompt_latent = port.extract_prompt_latent(prompt_24k)
    lm_spk, flow_emb = port.speaker_embedding(
        port.extract_prompt_mel(prompt_24k))
    text, ptext = rng.integers(0, 256, 5), rng.integers(0, 256, 3)
    key = jax.random.PRNGKey(11)

    wav_j, tim_j = ref.synthesize_fused(
        text, ptext, prompt_tokens, prompt_latent,
        jnp.asarray(lm_spk.numpy()), jnp.asarray(flow_emb.numpy()), key=key,
        return_timings=True)
    g_top, g_fb = jax_decode_noise(key, pcfg.lm, pcfg.max_speech_tokens, 1)
    wav_t, tim_t = port.synthesize_fused(
        text, ptext, prompt_tokens, prompt_latent, lm_spk, flow_emb,
        gumbel_top=g_top, gumbel_fallback=g_fb, return_timings=True)

    assert tim_t["tokens"] == tim_j["tokens"] >= 10
    assert len(wav_t) == len(wav_j) == tim_j["tokens"] * 2 * 480
    pcm_t = np.round(wav_t * 32767).astype(np.int32)
    pcm_j = np.round(np.asarray(wav_j) * 32767).astype(np.int32)
    assert np.abs(pcm_j).max() > 300  # audible, not silence
    assert np.abs(pcm_t - pcm_j).max() <= 2


def test_npz_written_by_jax_loads_into_port(trees, tmp_path):
    _, pcfg = tiny_port_cfg()
    path = str(tmp_path / "flow.npz")
    j_io.save_params(path, trees["flow"])
    pipe = t_pl.TTSPipeline(pcfg, device="cpu")
    t_io.load_flax_params(pipe.flow, t_io.load_params(path))
    back = t_io.to_flax_params(pipe.flow)
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(trees["flow"])[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))


def test_default_config_equals_yaml():
    assert t_config.load_tts_config(REPO / "configs/default.yaml") \
        == t_pl.TTSConfig()


def test_yaml_configs_match_jax():
    """Every field the port shares with the JAX config tree reads the same
    from each YAML of the repo."""
    def shared(j, t):
        for f in dataclasses.fields(t):
            a, b = getattr(j, f.name), getattr(t, f.name)
            if dataclasses.is_dataclass(b):
                shared(a, b)
            else:
                assert a == b, (type(t).__name__, f.name, a, b)

    for name in ("default", "tiny", "hf"):
        path = REPO / "configs" / f"{name}.yaml"
        shared(j_config.load_tts_config(path), t_config.load_tts_config(path))
    cfg = t_config.load_tts_config(REPO / "configs/tiny.yaml",
                                   ["model.lm.top_k=7",
                                    "model.flow.cfm.sigma_min=2e-3"])
    assert cfg.lm.top_k == 7 and cfg.flow.cfm.sigma_min == 2e-3


def test_entry_points_need_the_named_device(trees):
    """Without a GPU, every entry point called without device='cpu'
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from minimax_speech_torch.models import flow as t_flow
    _, pcfg = tiny_port_cfg()
    for call in (lambda: t_pl.TTSPipeline(pcfg),
                 lambda: t_pl.TTSPipeline.from_random(pcfg),
                 lambda: t_pl.TTSPipeline.from_flax(
                     pcfg, trees["lm"], trees["flow"], trees["codec"],
                     trees["s3"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    flow = t_flow.FlowModel(pcfg.flow)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_flow.flow_inference_batched(
            flow, np.zeros((1, 4), np.int64), [4],
            np.zeros((1, 2, 80), np.float32), [2],
            np.zeros((1, 12), np.float32), np.zeros((1, 8, 80), np.float32))


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py (imported, not run) and the port load no jax, flax,
    JAX package, transformers or tokenizers module."""
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "import minimax_speech_torch.cli.train, "
        "minimax_speech_torch.cli.launch, "
        "minimax_speech_torch.kernels.splash, "
        "minimax_speech_torch.parallel.layers, "
        "minimax_speech_torch.train.steps, "
        "minimax_speech_torch.utils.distributed, "
        "minimax_speech_torch.utils.gang, "
        "minimax_speech_torch.cli.train_dac, "
        "minimax_speech_torch.cli.train_hift, "
        "minimax_speech_torch.cli.extract_fsq, "
        "minimax_speech_torch.cli.extract_dac_latents, "
        "minimax_speech_torch.cli.extract_embedding, "
        "minimax_speech_torch.cli.eval_dac, "
        "minimax_speech_torch.train.gan_loop, "
        "minimax_speech_torch.data.audio_folder, "
        "minimax_speech_torch.cli.codec, "
        "minimax_speech_torch.cli.convert_checkpoint, "
        "minimax_speech_torch.infer.codec_file, "
        "minimax_speech_torch.infer.whisper_tokenizer, "
        "minimax_speech_torch.infer.api, "
        "minimax_speech_torch.models.campplus, "
        "minimax_speech_torch.ops.kaldi_fbank, "
        "minimax_speech_torch.utils.onnx_reader, "
        "minimax_speech_torch.utils.convert, "
        "minimax_speech_torch.utils.audio_signal, "
        "minimax_speech_torch.utils.audio_transforms, "
        "minimax_speech_torch.ops.interpolate, "
        "minimax_speech_torch.ops.monotonic_align, "
        "minimax_speech_torch.models.legacy_flow, "
        "minimax_speech_torch.models.legacy_lm, "
        "minimax_speech_torch.models.matcha, "
        "minimax_speech_torch.models.matcha_hifigan, "
        "minimax_speech_torch.infer.matcha_text, "
        "minimax_speech_torch.cli.matcha, "
        "minimax_speech_torch.cli.train_matcha, "
        "minimax_speech_torch.flowae.fm, "
        "minimax_speech_torch.flowae.dit, "
        "minimax_speech_torch.flowae.consistency_unet, "
        "minimax_speech_torch.flowae.dito, "
        "minimax_speech_torch.flowae.trainer, "
        "minimax_speech_torch.flowae.zdm, "
        "minimax_speech_torch.flowae.glpto, "
        "minimax_speech_torch.flowae.evaluate, "
        "minimax_speech_torch.flowae.image, "
        "minimax_speech_torch.flowae.vqgan, "
        "minimax_speech_torch.data.image_folder, "
        "minimax_speech_torch.data.webdataset, "
        "minimax_speech_torch.cli.train_flowae, "
        "minimax_speech_torch.cli.train_flowae_image, "
        "minimax_speech_torch.cli.dito_infer, "
        "minimax_speech_torch.cli.image_dito, "
        "minimax_speech_torch.cli.export, "
        "minimax_speech_torch.cli.hub_tools, "
        "minimax_speech_torch.cli.download_pretrained, "
        "minimax_speech_torch.cli.download_dataset, "
        "minimax_speech_torch.utils.registry, "
        "minimax_speech_torch.utils.preference, "
        "minimax_speech_torch.infer.qwen_tokenizer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'minimax_speech_tpu', 'transformers', 'tokenizers')]\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_runs_every_phase_once():
    """chip_smoke.py's main and its STREAMS together time each of phases
    1-50 exactly once; each stream is a worker's entry; merge updates one
    level into the kernels line's dicts."""
    import inspect
    import re

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    assert set(cs.STREAM_FNS) == set(cs.STREAMS)
    phases = []
    for fn in (cs.main, *cs.STREAM_FNS.values()):
        phases += [int(n) for n in
                   re.findall(r"phase_time\((\d+),", inspect.getsource(fn))]
    assert sorted(phases) == list(range(1, 51))
    rec = {"launches_by_path": {"a": 1}, "launches": 560}
    cs.merge(rec, {"launches_by_path": {"b": 0}, "flowae": {"x": 1}})
    assert rec == {"launches_by_path": {"a": 1, "b": 0}, "launches": 560,
                   "flowae": {"x": 1}}
