"""Weight bridge between the JAX package and its PyTorch port, and the
helpers the other tests/test_torch_*.py files share.

Both sides run on the CPU in float32. Weights are made by JAX's own
initializers, then jittered from a numpy seed so that no parameter sits
at a special value (zero biases, unit norms, zero-init projections)
where a mapping fault would not show.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import llm as j_llm
from minimax_speech_tpu.utils import params_io as j_io
from tests.test_pipeline import tiny_cfg
from tests import torch_cpu

torch_cpu.share_cores()


def port_config(jax_cfg, port_type):
    """The port's dataclass with the fields of a JAX config dataclass
    (fields only the JAX package has are dropped)."""
    kwargs = {}
    for f in dataclasses.fields(port_type):
        v = getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(v):
            sub = f.default_factory() if f.default_factory is not \
                dataclasses.MISSING else f.default
            v = port_config(v, type(sub))
        kwargs[f.name] = v
    return port_type(**kwargs)


def tiny_port_cfg():
    """(JAX tiny config of tests/test_pipeline.py, the port's twin)."""
    from minimax_speech_torch.infer import pipeline as t_pl
    jcfg = tiny_cfg()
    return jcfg, port_config(jcfg, t_pl.TTSConfig)


def jitter(tree, seed: int = 0):
    """Every float leaf plus seeded noise: half the leaf's spread, or 0.05
    for constant leaves. Returns a tree of numpy arrays."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            return a
        s = 0.5 * float(a.std()) if a.size > 1 and a.std() > 0 else 0.05
        return (a + s * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map(f, tree)


def to_np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def lm_pair():
    from minimax_speech_torch.models import llm as t_llm
    jcfg, pcfg = tiny_port_cfg()
    model = j_llm.SpeechLM(jcfg.lm)
    variables = jitter(j_llm.init_lm_variables(model, jax.random.PRNGKey(0)))
    return model, variables, t_llm.SpeechLM(pcfg.lm)


def test_flax_tree_round_trips_through_port(lm_pair):
    """flax tree -> port modules -> flax tree is the identity, leaf for
    leaf (the layout maps are exact transposes)."""
    _, variables, port = lm_pair
    t_io.load_flax_params(port, variables)
    back = t_io.to_flax_params(port)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_a[k]), flat_b[k])


def test_bridge_raises_on_unused_and_missing_leaves(lm_pair):
    _, variables, port = lm_pair
    extra = jax.tree_util.tree_map(lambda a: a, variables)
    extra["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        t_io.load_flax_params(port, extra)
    missing = jax.tree_util.tree_map(lambda a: a, variables)
    del missing["params"]["llm_decoder"]["bias"]
    with pytest.raises(KeyError, match="llm_decoder/bias"):
        t_io.load_flax_params(port, missing)
    wrong = jax.tree_util.tree_map(lambda a: a, variables)
    wrong["params"]["llm_decoder"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="llm_decoder/kernel"):
        t_io.load_flax_params(port, wrong)


def test_npz_written_by_port_loads_in_jax(lm_pair, tmp_path):
    """The port's save_params writes the JAX package's .npz format: JAX
    loads it, and its hidden states equal those of the original tree."""
    model, variables, port = lm_pair
    t_io.load_flax_params(port, variables)
    path = str(tmp_path / "lm.npz")
    t_io.save_params(path, port)
    loaded = j_io.load_params(path)
    emb = jnp.asarray(np.random.default_rng(3).standard_normal((1, 6, 32)),
                      jnp.float32)
    pos = jnp.arange(6)[None]
    bias = jnp.zeros((1, 1, 6, 6))

    def hidden(v):
        return np.asarray(model.apply(
            v, emb, pos, bias,
            method=lambda m, e, p, b: m.llm(e, p, b)[0]))

    np.testing.assert_array_equal(hidden(loaded), hidden(variables))


def test_flax_style_init_is_seeded():
    from minimax_speech_torch.models import llm as t_llm
    _, pcfg = tiny_port_cfg()
    a = t_io.init_params(t_llm.SpeechLM(pcfg.lm),
                         torch.Generator().manual_seed(4))
    b = t_io.init_params(t_llm.SpeechLM(pcfg.lm),
                         torch.Generator().manual_seed(4))
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), n
    w = a.llm.layers[0].mlp.down_proj.weight  # lecun normal, fan_in 64
    assert abs(float(w.detach().std()) - 64 ** -0.5) < 0.03


FLOWAE_MODULES = tuple(
    [f"minimax_speech_torch.flowae.{m}" for m in (
        "fm", "dit", "consistency_unet", "dito", "trainer", "zdm", "glpto",
        "evaluate", "image", "vqgan")]
    + ["minimax_speech_torch.data.image_folder",
       "minimax_speech_torch.data.webdataset"]
    + [f"minimax_speech_torch.cli.{m}" for m in (
        "train_flowae", "train_flowae_image", "dito_infer", "image_dito")])
# the host tools and export; the Qwen2 tokenizer, ported last
HOST_TOOL_MODULES = tuple(
    [f"minimax_speech_torch.cli.{m}" for m in (
        "export", "hub_tools", "download_pretrained", "download_dataset")]
    + [f"minimax_speech_torch.utils.{m}" for m in ("registry",
                                                   "preference")]
    + ["minimax_speech_torch.infer.qwen_tokenizer"])


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax, flax, JAX
    package, transformers or tokenizers module; the walk reaches each of
    FLOWAE_MODULES and HOST_TOOL_MODULES."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import minimax_speech_torch as p\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        f"missing = set({FLOWAE_MODULES + HOST_TOOL_MODULES!r}) - names\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
        "'minimax_speech_tpu', 'transformers', 'tokenizers')]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
