"""The seeded traffic generator: deterministic per seed, the same sizes
and gaps in another order across seeds, the Poisson schedule's rate, the
length ranges."""
import numpy as np

from speechbench import traffic

MIX = traffic.load("stream-open")
TRAIN = traffic.load("train-dynamic")


def reqs(mix, seed, n=64, stream=1):
    return traffic.speech_requests(mix, n, seed, text_vocab=151936,
                                   speech_vocab=6561, lm_width=896,
                                   stream=stream)


def test_requests_are_deterministic_per_seed():
    a, b = reqs(MIX, 2**31 + 5), reqs(MIX, 2**31 + 5)
    for x, y in zip(a, b):
        for f in ("text_tokens", "prompt_speech_tokens", "prompt_feat",
                  "lm_spk", "flow_emb"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
        assert x.greedy == y.greedy
    c = reqs(MIX, 2**31 + 6)
    assert any(not np.array_equal(x.text_tokens, y.text_tokens)
               for x, y in zip(a, c))


def test_sizes_in_range_and_the_same_multiset_for_every_seed():
    mix = MIX
    sizes = []
    for seed in (1, 99, 2**33):
        rs = reqs(mix, seed, n=32)
        t = sorted(len(r.text_tokens) for r in rs)
        p = sorted(len(r.prompt_speech_tokens) for r in rs)
        pt = sorted(len(r.prompt_text_tokens) for r in rs)
        assert mix["text_tokens"][0] <= t[0] and t[-1] <= mix["text_tokens"][1]
        assert mix["prompt_speech_tokens"][0] <= p[0] \
            and p[-1] <= mix["prompt_speech_tokens"][1]
        assert mix["prompt_text_tokens"][0] <= pt[0] \
            and pt[-1] <= mix["prompt_text_tokens"][1]
        assert all(r.prompt_feat.shape == (2 * len(r.prompt_speech_tokens),
                                           80) for r in rs)
        assert all(abs(np.linalg.norm(r.flow_emb) - 1) < 1e-5 for r in rs)
        sizes.append((t, p, pt))
    assert sizes[0] == sizes[1] == sizes[2]
    # every value of the text range is drawn
    assert set(sizes[0][0]) == set(range(mix["text_tokens"][0],
                                         mix["text_tokens"][1] + 1))


def test_every_nth_request_is_greedy():
    rs = reqs(MIX, 7, n=40)
    assert [r.greedy for r in rs] == [i % MIX["greedy_every"] == 0
                                      for i in range(40)]


def test_poisson_schedule_rate_and_order():
    mix = {"rate_per_s": 1.7, "schedule_seed": 11}
    a = traffic.arrivals(mix, 600.0)
    b = traffic.arrivals(dict(mix, schedule_seed=12), 600.0)
    gaps_a, gaps_b = np.diff(np.r_[0, a]), np.diff(np.r_[0, b])
    assert np.all(gaps_a > 0)
    assert abs(1.0 / gaps_a.mean() - 1.7) / 1.7 < 0.01
    assert a[-1] >= 600.0
    # exponential gaps: the share above the mean is e^-1
    assert abs(np.mean(gaps_a > gaps_a.mean()) - np.exp(-1)) < 0.03
    assert np.allclose(np.sort(gaps_a), np.sort(gaps_b))
    assert not np.allclose(gaps_a, gaps_b)
    assert np.array_equal(a, traffic.arrivals(dict(mix), 600.0))


def test_training_utterances_lognormal_lengths():
    u = traffic.train_utterances(TRAIN, 5, 512, text_vocab=151936,
                                 speech_vocab=6561)
    s = np.array([len(x["speech_token"]) for x in u])
    t = np.array([len(x["text_token"]) for x in u])
    lo, hi = TRAIN["speech_tokens"]
    assert s.min() >= lo and s.max() <= hi
    assert abs(np.median(s) - TRAIN["speech_median"]) <= 2
    assert t.min() >= TRAIN["text_tokens"][0] \
        and t.max() <= TRAIN["text_tokens"][1]
    assert all(len(x["speech_latent"]) == 2 * len(x["speech_token"])
               for x in u)
    v = traffic.train_utterances(TRAIN, 6, 512, text_vocab=151936,
                                 speech_vocab=6561)
    assert sorted(s) == sorted(len(x["speech_token"]) for x in v)
    assert [len(x["speech_token"]) for x in u] != \
        [len(x["speech_token"]) for x in v]


def test_one_schedule_for_every_seed():
    """A served mix's arrivals and order of sizes are its own
    `schedule_seed`'s, the same for every seed; the seed draws the
    contents. The schedule keeps its bursts."""
    a = traffic.arrivals(MIX, 100.0)
    gaps = np.diff(a)
    assert gaps.max() > 2.5 / MIX["rate_per_s"]
    assert gaps.min() < 0.2 / MIX["rate_per_s"]
    x, y = reqs(MIX, 1, n=40), reqs(MIX, 2, n=40)
    assert [len(r.text_tokens) for r in x] == [len(r.text_tokens) for r in y]
    assert [len(r.prompt_speech_tokens) for r in x] == \
        [len(r.prompt_speech_tokens) for r in y]
    assert any(not np.array_equal(r.text_tokens, q.text_tokens)
               for r, q in zip(x, y))
