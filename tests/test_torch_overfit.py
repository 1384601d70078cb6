"""The port's learn-and-speak proof (cli/overfit_pipeline.py) and its bf16
flow A/B (cli/eval_bf16_flow.py) against the JAX package's scripts on
the CPU, at configs/tiny.yaml with the proof's overrides and random
weights:

  * make_corpus writes the JAX script's wavs, texts, lists and metadata,
    byte for byte;
  * the three metric helpers agree with JAX's to 1e-6;
  * on one model directory (the .npz format is shared) JAX's `evaluate`
    and the port's, the port fed JAX's flow draws, agree on the
    deterministic metrics;
  * the port's `run` writes every artefact and returns the JAX script's
    keys; `evaluate_zero_shot` runs on held-out utterances; draw_sweep's
    decode tables replay;
  * TTSConfig.bf16_flow against float32 (tests/test_pipeline.py's
    bounds) and against the JAX package's bf16 flow on the same weights.

scripts/ is imported through sys.path, as tests/test_overfit_e2e.py
does; the port imports nothing of it.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch import config as t_cfg
from minimax_speech_torch.cli import eval_bf16_flow as t_bf16
from minimax_speech_torch.cli import overfit_pipeline as t_ofp
from minimax_speech_torch.infer.pipeline import TTSPipeline
from minimax_speech_torch.models import flow as t_flow
from minimax_speech_torch.models.flow import flow_inference
from minimax_speech_torch.utils import params_io
from tests import torch_cpu

torch_cpu.share_cores()
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import overfit_pipeline as j_ofp  # noqa: E402

TINY = str(REPO / "configs/tiny.yaml")


def tree_bytes(root: Path) -> dict:
    """{relative path: bytes} of every file under root, with root's path
    replaced by a marker wherever a file names it."""
    return {str(p.relative_to(root)): p.read_bytes().replace(
                str(root).encode(), b"<root>")
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kw", [
    dict(n_utts=2, seg_seconds=0.5),
    dict(n_utts=6, seg_seconds=0.4, n_speakers=2, holdout_per_speaker=1,
         n_extra_texts=2)], ids=["one_voice", "zero_shot"])
def test_make_corpus_matches_jax(tmp_path, kw):
    """The corpus, its lists and metadata, byte for byte."""
    jm = j_ofp.make_corpus(tmp_path / "jax", **kw)
    tm = t_ofp.make_corpus(tmp_path / "torch", **kw)
    assert tree_bytes(tmp_path / "jax") == tree_bytes(tmp_path / "torch")
    assert json.dumps(jm).replace(str(tmp_path / "jax"), "<root>") == \
        json.dumps(tm).replace(str(tmp_path / "torch"), "<root>")


def test_metric_helpers_match_jax():
    """_xcorr_peak, _mel_spectral_l1 and _mel_content_match on seeded
    audio (a melody against a noisy, shifted copy and against another
    melody): _xcorr_peak is the same numpy and agrees to 1e-12; the mel
    helpers take float32 log-mels, by torch against jnp, whose values
    reach |log(1e-5)| = 11.5 (an ulp ~1e-6) and whose FFTs round
    differently: they agree to 1e-5 (measured 8.6e-6 at most, on the
    noisy copy's spectral loss of 9.75)."""
    rng = np.random.default_rng(3)
    x = t_ofp._synth(rng.integers(0, 6, 6), 0.8, 24000)
    y = (np.roll(x, 37) + 0.05 * rng.standard_normal(len(x))).astype(
        np.float32)[:-500]
    other = t_ofp._synth(rng.integers(0, 6, 6), 0.8, 24000)
    for y_ in (y, other):
        for name in ("_xcorr_peak", "_mel_spectral_l1",
                     "_mel_content_match"):
            args = (x, y_, 480) if name == "_xcorr_peak" else (x, y_)
            got = np.atleast_1d(getattr(t_ofp, name)(*args))
            want = np.atleast_1d(getattr(j_ofp, name)(*args))
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=1e-12 if name == "_xcorr_peak" else 1e-5, err_msg=name)


def write_model_dir(root: Path, meta: dict, seed: int = 0) -> Path:
    """A model directory of random weights at the proof's geometry
    (tiny.yaml with overfit_overrides) and ground-truth sidecars for the
    corpus: FSQ tokens and 2x latents from a seeded numpy generator."""
    import yaml

    data = t_cfg.apply_overrides(t_cfg.load_yaml(TINY),
                                 t_ofp.overfit_overrides())
    cfg = t_cfg.build_tts_config(data["model"])
    model_dir = root / "model"
    model_dir.mkdir(parents=True)
    (model_dir / "config.yaml").write_text(yaml.safe_dump(data))
    pipe = TTSPipeline.from_random(cfg, seed, device="cpu")
    for name, m in zip(("llm", "flow", "codec", "s3"),
                       pipe.models().values()):
        params_io.save_params(str(model_dir / f"{name}.npz"), m)
    rng = np.random.default_rng(seed)
    for u in meta["utts"]:
        stem = str(Path(u["wav"]).with_suffix(""))
        n = int(2 * meta["seg_seconds"] * 25)
        np.save(stem + "_fsq.npy", rng.integers(0, 6561, n).astype(np.int32))
        np.savez(stem + "_latent2x.npz", mu=rng.standard_normal(
            (2 * n, 80)).astype(np.float32))
    return model_dir


def jax_flow_draws(shape) -> list:
    """The three extra start noises of JAX's evaluate: PRNGKey(100) split
    in turn."""
    dkey, out = jax.random.PRNGKey(100), []
    for _ in range(3):
        dkey, kk = jax.random.split(dkey)
        out.append(np.array(jax.random.normal(kk, shape, jnp.float32)))
    return out


@pytest.fixture(scope="module")
def held_in(tmp_path_factory):
    """A one-voice corpus of 2 utterances, its model directory, and JAX's
    evaluate on it."""
    root = tmp_path_factory.mktemp("held_in")
    meta = j_ofp.make_corpus(root / "corpus", n_utts=2, seg_seconds=0.6)
    model_dir = write_model_dir(root, meta)
    return root, meta, model_dir, j_ofp.evaluate(model_dir, root / "corpus",
                                                 meta)


def test_evaluate_matches_jax(held_in):
    """The port's evaluate on JAX's flow draws: the flow reconstruction
    (one draw and the 4-draw mean: float32 in other summation orders,
    rel 1e-4), the mel spectral loss of the mean's decode (1e-4) and the
    codec's SNR and correlation (1e-3 dB, 1e-5) agree with JAX's. The
    sampled keys (tokens, synthesis) take the port's own draws and are
    only checked to be there."""
    root, meta, model_dir, want = held_in
    got = t_ofp.evaluate(model_dir, root / "corpus", meta, device="cpu",
                         flow_noises=jax_flow_draws((1, 15000, 80)))
    assert set(got) == set(want)
    for key, rtol, atol in (("flow_mse", 1e-4, 0), ("flow_nmse", 1e-4, 0),
                            ("flow_nmse_mean4", 1e-4, 0),
                            ("mel_spectral_loss", 1e-4, 0),
                            ("dac_snr_db", 0, 1e-3), ("dac_corr", 0, 1e-5)):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=key)
    assert got["expect_len"] == want["expect_len"]
    assert all(np.isfinite(v) for v in got.values())


def test_draw_sweep_replays_the_decode_tables(held_in):
    """draw_sweep's row for a seed holds evaluate's draw-dependent keys;
    the decode tables it drew (the LM continuation's and one per
    synthesis), replayed under another seed, give the same keys: so a
    device's tables replayed on the CPU compare the decodes on one
    draw."""
    root, meta, model_dir, _ = held_in
    tables = []
    with t_ofp._decode_tables(tables):
        rows = t_ofp.draw_sweep(model_dir, root / "corpus", meta, [3],
                                device="cpu")
    assert [sorted(r) for r in rows] == [["cpu", "seed"]]
    assert set(rows[0]["cpu"]) == set(t_ofp.DRAW_KEYS)
    assert len(tables) >= 3
    with t_ofp._decode_tables(tables, replay=True):
        got = t_ofp.evaluate(model_dir, root / "corpus", meta, device="cpu",
                             draw_seed=7)
    assert {k: got[k] for k in t_ofp.DRAW_KEYS} == rows[0]["cpu"]


def test_prompt_drift_is_nothing_on_the_cpu(held_in):
    """prompt_drift on the CPU against itself: every token, latent and
    speaker vector the same, under both cuDNN settings."""
    root, meta, model_dir, _ = held_in
    got = t_ofp.prompt_drift(model_dir, meta, device="cpu")
    assert sorted(got) == ["cudnn_fp32", "cudnn_tf32"]
    for rec in got.values():
        assert rec["tokens"][0] == rec["tokens"][1] > 0
        assert rec["tokens_differ"] == 0
        assert rec["prompt_feat_max_abs"] == rec["lm_spk_max_abs"] \
            == rec["flow_emb_max_abs"] == 0.0


def test_run_writes_every_artefact(tmp_path, held_in):
    """The port's run on the CPU at a few steps a stage (2 utterances):
    every stage's output, the JAX script's keys; a second run resumes
    (every stage skipped: the metrics come back equal)."""
    want = held_in[3]
    budget = dict(n_utts=2, seg_seconds=0.5, dac_iters=2, flow_epochs=2,
                  flow_polish_epochs=1, llm_epochs=2, config=TINY,
                  device="cpu")
    stats = {}
    got = t_ofp.run(tmp_path / "w", stats=stats, **budget)
    model = tmp_path / "w" / "model"
    for name in ("s3.npz", "codec.npz", "flow.npz", "llm.npz",
                 "config.yaml", "latent_stats.json", "flow_polished"):
        assert (model / name).exists(), name
    for i in range(2):
        for suffix in ("_fsq.npy", "_latent2x.npz"):
            assert (tmp_path / "w" / "corpus" / f"utt{i}{suffix}").exists()
    assert set(got) == {"llm_train_acc", "llm_train_loss",
                        "flow_train_loss"} | set(want)
    assert set(stats) == {"extract_fsq", "train_dac",
                          "extract_dac_latents", "train_flow",
                          "train_flow_polish", "train_llm", "evaluate"}
    # the plain versions run on the CPU: no kernel launch
    assert {k for st in stats.values() for k, v in st.items()
            if k != "s" and v} == set()
    again = {}
    assert json.dumps(t_ofp.run(tmp_path / "w", stats=again, **budget),
                      sort_keys=True) == json.dumps(got, sort_keys=True)
    assert set(again) == {"evaluate"}


def test_evaluate_zero_shot_on_held_out(tmp_path):
    """evaluate_zero_shot on a 2-speaker corpus with one held-out
    utterance each: both scored, every key of the JAX script's result."""
    meta = t_ofp.make_corpus(tmp_path / "corpus", n_utts=4, seg_seconds=0.5,
                             n_speakers=2, holdout_per_speaker=1)
    model_dir = write_model_dir(tmp_path, meta)
    got = t_ofp.evaluate_zero_shot(model_dir, meta, device="cpu")
    assert got["zs_n_holdout"] == 2
    assert [r["utt"] for r in got["zs_per_utt"]] == ["utt2", "utt3"]
    assert set(got) == {"zs_pitch_acc", "zs_mel_dev_corr", "zs_pitch_acc_gt",
                        "zs_wav_corr_gt", "zs_rel_len_err", "zs_eos_ok",
                        "zs_n_holdout", "zs_per_utt"}
    assert all(np.isfinite(v) for k, v in got.items() if k != "zs_per_utt")


def test_device_cuda_raises_without_a_gpu(tmp_path):
    """Both CLIs default to cuda and raise without a GPU before any work."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ofp.main(["--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_bf16.main(["--workdir", str(tmp_path / "w")])


def test_bf16_flow_matches_fp32_and_jax():
    """TTSConfig.bf16_flow on tiny weights: against the port's float32
    flow within tests/test_pipeline.py's bounds (corr > 0.995, rel L1 <
    0.05), and against the JAX package's bf16 flow on the same weights
    and inputs (both round the same float32 weights to bf16; activations
    round at other places, so the same bounds)."""
    from minimax_speech_tpu import config as j_cfg
    from minimax_speech_tpu.models.flow import FlowModel, flow_inference as jf
    from minimax_speech_tpu.utils import params_io as j_io

    cfg = t_cfg.load_tts_config(TINY)
    p32 = TTSPipeline.from_random(cfg, 0, device="cpu")
    tree = params_io.to_flax_params(p32.flow)
    p16 = TTSPipeline.from_random(dataclasses.replace(cfg, bf16_flow=True),
                                  0, device="cpu")
    assert t_flow.flow_dtype(p16.flow) == torch.bfloat16
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 100, (1, 32))
    pf = np.zeros((1, 16, cfg.flow.output_size), np.float32)
    emb = rng.standard_normal((1, cfg.flow.spk_embed_dim)).astype(np.float32)
    f32 = flow_inference(p32.flow, tok, [32], pf, emb, p32.noise,
                         device="cpu").numpy()
    f16 = flow_inference(p16.flow, tok, [32], pf, emb, p16.noise,
                         device="cpu")
    assert f16.dtype == torch.bfloat16
    f16 = f16.float().numpy()

    def close(a, b):
        corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
        rel = np.abs(a - b).mean() / (np.abs(b).mean() + 1e-9)
        assert corr > 0.995 and rel < 0.05, (corr, rel)

    close(f16, f32)
    jcfg = j_cfg.load_tts_config(TINY)
    jvars = j_io.cast_floats(tree, jnp.bfloat16)
    j16 = np.asarray(jf(FlowModel(jcfg.flow), jvars, jnp.asarray(tok),
                        jnp.array([32]), *j_io.cast_floats(
                            [jnp.asarray(pf), jnp.asarray(emb),
                             jnp.asarray(p32.noise.numpy())], jnp.bfloat16)),
                     np.float32)
    close(f16, j16)
    # the speaker encoder: float32 activations on bf16-rounded weights,
    # as JAX promotes bf16 parameters against a float32 mel
    for a, b in zip(p16.flow.speaker_encoder.parameters(),
                    p32.flow.speaker_encoder.parameters()):
        assert a.dtype == torch.float32
        assert torch.equal(a, b.bfloat16().float())
    mel = rng.standard_normal((40, 80)).astype(np.float32)
    assert p16.speaker_embedding(mel)[1].dtype == torch.float32


def test_eval_bf16_flow_on_a_workdir(held_in):
    """cli/eval_bf16_flow on the held-in model directory: the JAX
    script's keys, fp32 and bf16 NMSE close (random weights) and the
    first draw's bf16-vs-fp32 error small."""
    root = held_in[0]
    got = t_bf16.evaluate(root, draws=2, device="cpu")
    assert set(got) == {"fp32", "bf16", "latent_rel_err"}
    for mode in ("fp32", "bf16"):
        assert set(got[mode]) == {"flow_nmse", "flow_nmse_mean2"}
    np.testing.assert_allclose(got["bf16"]["flow_nmse"],
                               got["fp32"]["flow_nmse"], rtol=0.05)
    assert got["latent_rel_err"] < 0.05
