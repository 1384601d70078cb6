"""The port's synthesis CLI, its unfused `synthesize` and its text
frontend.

CPU, configs/tiny.yaml scale. The CLI writes a wav in both modes, from
random weights or from a checkpoint directory of .npz files; the
unfused path gives the JAX package's tokens and PCM within 2 LSB (float32
sums in other orders through the LM, 2 Euler steps and the codec); the
text normalizer and the Frontend give the JAX package's strings and ids,
and pass the cases of tests/test_textnorm.py and
tests/test_session_frontend.py.
"""
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minimax_speech_torch.cli import synthesize as t_cli
from minimax_speech_torch.infer import frontend as t_fe
from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.infer import textnorm as t_tn
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.infer import frontend as j_fe
from minimax_speech_tpu.infer import pipeline as j_pl
from minimax_speech_tpu.infer import textnorm as j_tn
from tests.conftest import synthetic_audio
from tests.test_torch_bridge import jitter, tiny_port_cfg
from tests.test_torch_lm import jax_decode_noise
from tests import torch_cpu

torch_cpu.share_cores()

TINY = "configs/tiny.yaml"


def _read_wav(path):
    with wave.open(str(path)) as w:
        assert w.getframerate() == 24000 and w.getnchannels() == 1
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.mark.parametrize("stream", [False, True])
def test_cli_writes_wav(tmp_path, stream):
    out = tmp_path / "out.wav"
    argv = ["--random_init", "--device", "cpu", "--config", TINY,
            "--text", "Hello there. It is 3 pm.", "--out", str(out)]
    audio = t_cli.main(argv + (["--stream"] if stream else []))
    pcm = _read_wav(out)
    assert len(pcm) == len(audio) > 0 and len(pcm) % 480 == 0
    assert np.isfinite(audio).all() and np.abs(pcm).max() > 0


def test_cli_loads_checkpoint_dir(tmp_path):
    """--ckpt_dir with {llm,flow,codec,s3}.npz (the JAX package's format)
    and a 24 kHz prompt wav."""
    from minimax_speech_torch import config as t_config
    cfg = t_config.load_tts_config(TINY)
    pipe = t_pl.TTSPipeline.from_random(cfg, seed=4, device="cpu")
    for name, m in zip(("llm", "flow", "codec", "s3"),
                       pipe.models().values()):
        t_io.save_params(str(tmp_path / f"{name}.npz"), m)
    prompt = tmp_path / "prompt.wav"
    t_cli.write_wav(str(prompt),
                    synthetic_audio(np.random.default_rng(0), 0.5, 24000))
    out = tmp_path / "out.wav"
    audio = t_cli.main(["--ckpt_dir", str(tmp_path), "--device", "cpu",
                        "--config", TINY, "--prompt_wav", str(prompt),
                        "--prompt_text", "a prompt", "--out", str(out)])
    assert len(_read_wav(out)) == len(audio) > 0


def test_cli_refuses_a_tokenizer_path_and_no_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a Qwen2 tokenizer"):
        t_cli.main(["--random_init", "--device", "cpu", "--config", TINY,
                    "--tokenizer_path", str(tmp_path)])
    with pytest.raises(SystemExit):
        t_cli.main(["--device", "cpu", "--config", TINY])


def test_synthesize_matches_jax(rng):
    """The unfused path: LM decode, tokens to the host, flow on the
    bucket-padded [prompt | generated] tokens, codec; weights and noise
    shared with the JAX package."""
    jcfg, pcfg = tiny_port_cfg()
    seed_pipe = t_pl.TTSPipeline.from_random(pcfg, seed=3, device="cpu")
    trees = [jitter(t_io.to_flax_params(m), seed=i)
             for i, m in enumerate(seed_pipe.models().values())]
    port = t_pl.TTSPipeline.from_flax(pcfg, *trees, device="cpu")
    ref = j_pl.TTSPipeline(jcfg, *trees[:3])
    a24 = synthetic_audio(rng, 0.6, 24000)
    prompt_tokens = rng.integers(0, 6561, 15)
    latent = port.extract_prompt_latent(a24)
    lm_spk, flow_emb = port.speaker_embedding(port.extract_prompt_mel(a24))
    text, ptext = rng.integers(0, 256, 5), rng.integers(0, 256, 3)
    key = jax.random.PRNGKey(11)
    wav_j, tim_j = ref.synthesize(
        text, ptext, prompt_tokens, latent, jnp.asarray(lm_spk.numpy()),
        jnp.asarray(flow_emb.numpy()), key=key, return_timings=True)
    g_top, g_fb = jax_decode_noise(key, pcfg.lm, pcfg.max_speech_tokens, 1)
    wav_t, tim_t = port.synthesize(
        text, ptext, prompt_tokens, latent, lm_spk, flow_emb,
        gumbel_top=g_top, gumbel_fallback=g_fb, return_timings=True)
    assert tim_t["tokens"] == tim_j["tokens"] >= 10
    assert len(wav_t) == len(wav_j) == tim_j["tokens"] * 2 * 480
    pcm_t = np.round(wav_t * 32767).astype(np.int32)
    pcm_j = np.round(np.asarray(wav_j) * 32767).astype(np.int32)
    assert np.abs(pcm_j).max() > 300
    assert np.abs(pcm_t - pcm_j).max() <= 2


TEXTS = ["I saw 1,234 birds", "pi is 3.14", "the 1st, 2nd, 3rd, 12th and 22nd",
         "it costs $5.20 now", "£10 and 50% off at 3:15 pm, 9:00 or 9:05",
         "it was -4 degrees", "Call 555-0199 on 3/4 at 12:30, pay $1,000.50!",
         "我有123个苹果", "涨了50%，只要¥10，2024年的事，下午3:15见",
         "约为3.14", "（你好）呀，", "你好.", "5平方米 x²", "I have 3 cats.",
         "我有3只猫。", ". ".join(f"sentence number {i} is here"
                                 for i in range(12)) + "."]


@pytest.mark.parametrize("text", TEXTS)
def test_normalizer_and_frontend_match_jax(text):
    assert t_tn.normalize_en(text) == j_tn.normalize_en(text)
    assert t_tn.normalize_zh(text) == j_tn.normalize_zh(text)
    assert t_fe.normalize_text(text) == j_fe.normalize_text(text)
    ours, ref = t_fe.Frontend(), j_fe.Frontend()
    pieces = ours.text_normalize(text)
    assert pieces == ref.text_normalize(text)
    assert ours.text_normalize(text, split=False) == \
        ref.text_normalize(text, split=False)
    for p in pieces:
        np.testing.assert_array_equal(ours.extract_text_tokens(p),
                                      ref.extract_text_tokens(p))


def test_textnorm_cases():
    """The cases of tests/test_textnorm.py on the port's copy."""
    tn = t_tn
    assert tn.normalize_en("I saw 1,234 birds") == \
        "I saw one thousand two hundred thirty four birds"
    assert "three point one four" in tn.normalize_en("pi is 3.14")
    out = tn.normalize_en("the 1st, 2nd, 3rd, 12th and 22nd")
    for w in ("first", "second", "third", "twelfth", "twenty-second"):
        assert w in out
    assert tn.normalize_en("it costs $5.20 now") == \
        "it costs five dollars and twenty cents now"
    assert "one dollar" in tn.normalize_en("$1 only")
    assert "ten pounds" in tn.normalize_en("£10")
    assert "fifty percent" in tn.normalize_en("50% off")
    assert "three fifteen" in tn.normalize_en("at 3:15 pm")
    assert "nine o'clock" in tn.normalize_en("at 9:00")
    assert "nine oh five" in tn.normalize_en("at 9:05")
    assert "minus four" in tn.normalize_en("it was -4 degrees")
    assert not any(c.isdigit() for c in tn.normalize_en(
        "Call 555-0199 on 3/4 at 12:30, pay $1,000.50!"))
    for n, s in ((0, "零"), (10, "十"), (14, "十四"), (123, "一百二十三"),
                 (1005, "一千零五"), (10000, "一万"), (100000001, "一亿零一"),
                 (-7, "负七")):
        assert tn.spell_number_zh(n) == s
    assert tn.normalize_zh("我有123个苹果") == "我有一百二十三个苹果"
    assert "百分之五十" in tn.normalize_zh("涨了50%")
    assert "十元" in tn.normalize_zh("只要¥10")
    assert "二零二四年" in tn.normalize_zh("2024年的事")
    assert "三点十五分" in tn.normalize_zh("下午3:15见")
    assert "三点一四" in tn.normalize_zh("约为3.14")
    assert tn.replace_blank("你 好 ab cd") == "你好ab cd"
    assert tn.replace_corner_mark("5平方米 x²") == "5平方米 x平方"
    assert tn.normalize_zh("（你好）呀，").endswith("。")
    assert "。" in tn.normalize_zh("你好.")
    assert tn.contains_chinese("你好 world")
    assert not tn.contains_chinese("hello world")
    assert tn.is_only_punctuation("。，！")
    assert tn.is_only_punctuation(" ... ")
    assert not tn.is_only_punctuation("嗯。")


def test_frontend_cases():
    """The Frontend cases of tests/test_textnorm.py and
    tests/test_session_frontend.py on the port's frontend."""
    f = t_fe.Frontend()
    assert f.text_normalize("我有3只猫。", split=True) == ["我有三只猫。"]
    assert f.text_normalize("I have 3 cats.", split=True) == \
        ["I have three cats."]
    text = "这是一个句子。" * 30
    chunks = t_fe.split_paragraph(text, lambda s: list(s), lang="zh",
                                  token_max_n=40, token_min_n=20,
                                  merge_len=10)
    assert len(chunks) > 1 and "".join(chunks) == text
    assert all(len(c) <= 48 for c in chunks)
    out = t_fe.normalize_text("I have 21 cats and 1005 dogs")
    assert "twenty one" in out and "one thousand five" in out
    assert not any(ch.isdigit() for ch in out)
    tok = t_fe.ByteTokenizer()
    text = ". ".join(f"sentence number {i} is here" for i in range(12)) + "."
    chunks = t_fe.split_paragraph(text, tok.encode, token_max_n=80)
    assert len(chunks) > 1
    ids = tok.encode("héllo wörld")
    assert min(ids) >= 1 and tok.decode(ids) == "héllo wörld"
    toks = f.extract_text_tokens("hello world")
    assert toks.dtype == np.int32 and len(toks) == 11
