"""The frozen traffic generators: seconds, seeds and the same work for
every seed."""
import numpy as np
import pytest

from bench import traffic as T

SEED = 2**31 + 977      # past 32 signed bits
OPEN = {"arrival": {"kind": "poisson", "rate": 8.0},
        "lengths": {"kind": "uniform", "prompt": [1024, 3584],
                    "output": [16, 128]},
        "warm_seconds": 8.0}
CLOSED = {"arrival": {"kind": "closed", "clients": 64, "per_client": 3},
          "lengths": {"kind": "table2", "mix": "heavy"}}


def _key(arrivals):
    return [(a.due, a.prompt_len, a.output_len) for a in arrivals]


def test_a_seed_gives_the_same_stream_and_another_seed_another_order():
    a = T.window_traffic(OPEN, SEED, 30.0)
    b = T.window_traffic(OPEN, SEED, 30.0)
    c = T.window_traffic(OPEN, SEED + 1, 30.0)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)
    # the same work in another order
    assert sorted(x.prompt_len for x in a) == sorted(x.prompt_len for x in c)
    assert sorted(x.output_len for x in a) == sorted(x.output_len for x in c)
    ga = np.sort(np.diff([0.0] + [x.due for x in a]))
    gc = np.sort(np.diff([0.0] + [x.due for x in c]))
    assert np.allclose(ga, gc)


def test_poisson_sends_rate_times_seconds_inside_the_window():
    for rate, seconds in ((8.0, 30.0), (3.3, 51.0), (0.5, 10.0)):
        due = T.poisson(rate, seconds, T.rng_for(SEED, 1))
        assert len(due) == round(rate * seconds)
        assert np.all(np.diff(due) > 0) and 0 < due[0] and due[-1] < seconds
        # exponential gaps: their spread is near their mean
        gaps = np.diff(np.concatenate([[0.0], due]))
        if len(gaps) > 100:
            assert 0.8 < gaps.std() / gaps.mean() < 1.2


def test_lengths_cover_their_ranges_evenly():
    p, o = T.sizes(OPEN["lengths"], 240, T.rng_for(SEED, 1))
    assert p.min() >= 1024 and p.max() <= 3584
    assert o.min() >= 16 and o.max() <= 128
    assert abs(p.mean() - (1024 + 3584) / 2) < 10
    assert abs(o.mean() - (16 + 128) / 2) < 1
    (plo, phi), (olo, ohi) = T.ranges(CLOSED["lengths"])
    assert (plo, phi, olo, ohi) == (500, 1000, 500, 1000)
    assert T.TABLE2["light"] == ((20, 500), (20, 500))


def test_mmpp_is_seeded_and_bursty():
    a = T.mmpp(12.0, 0.8, 2.0, 2.0, 200.0, T.rng_for(SEED, 1))
    b = T.mmpp(12.0, 0.8, 2.0, 2.0, 200.0, T.rng_for(SEED, 1))
    assert np.array_equal(a, b)
    assert np.all(np.diff(a) > 0) and a[-1] < 200.0
    # mean rate (12 + 0.8) / 2 = 6.4 a second, with bursts: counts per
    # second vary far more than a Poisson stream's
    assert 4.0 < len(a) / 200.0 < 9.0
    per_s = np.bincount(a.astype(int), minlength=200)
    assert per_s.var() > 2 * per_s.mean()
    arr = T.open_loop({"arrival": {"kind": "mmpp", "rate_on": 12.0,
                                   "rate_off": 0.8, "mean_on": 2.0,
                                   "mean_off": 2.0},
                       "lengths": OPEN["lengths"]}, 20.0,
                      T.rng_for(SEED, 1))
    assert [x.index for x in arr] == list(range(len(arr)))


def test_closed_loop_gives_each_client_its_own_requests():
    clients = T.window_traffic(CLOSED, SEED, 30.0)
    assert len(clients) == 64 and all(len(c) == 3 for c in clients)
    idx = [a.index for c in clients for a in c]
    assert sorted(idx) == list(range(64 * 3))
    assert all(a.client == k for k, c in enumerate(clients) for a in c)
    again = T.window_traffic(CLOSED, SEED, 30.0)
    assert [_key(c) for c in clients] == [_key(c) for c in again]


def test_warm_up_and_window_draw_from_streams_of_their_own():
    warm = T.warm_traffic(OPEN, SEED)
    window = T.window_traffic(OPEN, SEED, 8.0)
    assert len(warm) == 64 and _key(warm) != _key(window)


def test_prompt_ids_are_seeded_and_inside_the_vocabulary():
    a = T.prompt_ids(SEED, [5, 7, 3], 49152)
    b = T.prompt_ids(SEED, [5, 7, 3], 49152)
    assert [x.shape[0] for x in a] == [5, 7, 3]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    big = np.concatenate(T.prompt_ids(7, [20000], 122753))
    assert big.min() >= 0 and big.max() < 122753 and big.dtype == np.int32


@pytest.mark.parametrize("seed", [-5, 0, 2**63 + 5])
def test_any_whole_seed_gives_a_stream(seed):
    assert len(T.window_traffic(OPEN, seed, 5.0)) == 40


def test_a_closed_loop_starts_its_clients_out_of_step():
    """Each client's first request is part of the way through its answer:
    the parts are evenly spread over the clients, the answered tokens
    move into the prompt, and every later request is as drawn, one round
    of sizes at a time."""
    clients = T.window_traffic(CLOSED, SEED, 30.0)
    rng = T.rng_for(SEED, 1)
    (p0, o0), (p1, o1), (p2, o2) = [T.sizes(CLOSED["lengths"], 64, rng)
                                    for _ in range(3)]
    answered = []
    for k, c in enumerate(clients):
        a = c[0]
        assert a.prompt_len + a.output_len == p0[k] + o0[k]
        assert a.output_len >= 2
        answered.append((a.prompt_len - p0[k]) / o0[k])
        assert [(x.prompt_len, x.output_len) for x in c[1:]] == [
            (p1[k], o1[k]), (p2[k], o2[k])]
    # the answered parts run evenly from near 0 to near 1
    assert sorted(answered) == pytest.approx(
        list((np.arange(64) + 0.5) / 64), abs=2.0 / 500)


@pytest.mark.parametrize("seed", [SEED, 7, 2**40 + 3])
def test_every_seed_gives_a_closed_loop_the_same_work(seed):
    """Each round holds the same prompt and output lengths for every
    seed, and the first round leaves the same tokens to answer, so
    requests end in the window at the same iterations: the seed changes
    the order, not the work."""
    def work(s):
        clients = T.window_traffic(CLOSED, s, 30.0)
        return ([sorted(c[j].prompt_len for c in clients) for j in (1, 2)],
                [sorted(c[j].output_len for c in clients) for j in (1, 2)],
                sorted(c[0].output_len for c in clients),
                sum(c[0].prompt_len for c in clients))
    assert work(seed) == work(SEED + 1)
    first = [c[0].output_len for c in T.window_traffic(CLOSED, seed, 30.0)]
    assert first != [c[0].output_len
                     for c in T.window_traffic(CLOSED, SEED + 1, 30.0)]
