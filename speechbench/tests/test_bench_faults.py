"""A run at the tiny test geometry on the CPU, the harness's look for a
chip skipped: the program against the plain reference reads within the
cell's limits; with the timed path broken underneath, `correct` comes out
false; the control (the reference one precision step down in the
program's place) fails the limits too. The cell's own limits are used."""
import pytest
import torch

from speechbench import checks
from speechbench.drivers import stream, train
from speechbench.tests import support

torch.set_num_threads(2)

DRIVERS = {"dac.stream-open": stream, "lm.train": train}


def measure(workload, seed=3, seconds=2.0):
    ctx = support.context(workload, seed=seed, seconds=seconds)
    return DRIVERS[workload].measure(ctx), ctx


@pytest.mark.parametrize("workload", list(DRIVERS))
def test_sound_run_is_correct(workload):
    res, ctx = measure(workload)
    assert res["correct"], res["checks"]
    assert ctx.attempted > 0 and ctx.failed == 0
    for name, c in res["checks"].items():
        if name != "lm_gap":  # the serving LM runs in bfloat16
            assert c["value"] <= 1e-4, (name, c)


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from minimax_speech_torch.models import llm
    inner = llm.sample_step

    def altered(*a, **kw):  # every row's token, one id on
        return (inner(*a, **kw) + 1) % 6561

    monkeypatch.setattr(llm, "sample_step", altered)
    res, _ = measure("dac.stream-open")
    assert not res["correct"]
    assert res["checks"]["lm_gap"]["value"] > \
        res["checks"]["lm_gap"]["limit"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from minimax_speech_torch.train import schedule
    monkeypatch.setattr(schedule.Optimizer, "apply",
                        lambda self, params, grads, state, *a, **kw: True)
    res, _ = measure("lm.train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    from minimax_speech_torch.train import steps
    inner = steps.make_lm_loss_fn

    def halved(model, bf16=False):
        fn = inner(model, bf16)

        def loss_fn(b, group=None):
            n = (b["src_type"].shape[0] + 1) // 2
            return fn({k: v[:n] for k, v in b.items()}, group=group)
        return loss_fn

    monkeypatch.setattr(steps, "make_lm_loss_fn", halved)
    res, _ = measure("lm.train")
    assert not res["correct"]


def test_control_fails_the_limits():
    ctx = support.context("dac.stream-open", seed=4, seconds=2.0)
    run = stream.Run(ctx)
    run.run()
    run.free_program()
    ok, table = checks.verdict(run.check(lower=True),
                               checks.load_limits("dac.stream-open"))
    assert not ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(DRIVERS))
def test_control_fails_the_limits_on_the_card(workload):
    """At the cell's own size on the card, with a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import types

    from speechbench import run as harness
    from speechbench import traffic
    manifest, cell, config = support.cell_of(workload)
    a = types.SimpleNamespace(workload=workload, seed=5, seconds=10.0,
                              trace=0)
    ctx = harness.Context(a, manifest, cell, config,
                          traffic.load(cell["traffic"]),
                          torch.device("cuda", 0))
    run = DRIVERS[workload].Run(ctx)
    run.run()
    run.free_program()
    ok, table = checks.verdict(run.check(lower=True),
                               checks.load_limits(workload))
    assert not ok, table
