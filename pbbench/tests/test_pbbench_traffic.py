"""The traffic generator: deterministic in the seed, one multiset of work
for every seed, in another order."""
import numpy as np
import pytest

from pbb import manifest, traffic


@pytest.mark.parametrize("cell", ["opt-lora-chat", "moe-decode-batch"])
def test_same_seed_same_requests(cell):
    spec = manifest.traffic(cell)
    a = traffic.make(spec, 2 ** 31 + 12345, 30.0, 50272)
    b = traffic.make(spec, 2 ** 31 + 12345, 30.0, 50272)
    assert [(r.due, r.out_len, r.adapter) for r in a] == \
        [(r.due, r.out_len, r.adapter) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("cell", ["opt-lora-chat", "moe-decode-batch"])
def test_seeds_permute_one_multiset(cell):
    spec = manifest.traffic(cell)
    a = traffic.make(spec, 1, 30.0, 50272)
    b = traffic.make(spec, 2, 30.0, 50272)
    for key in (lambda r: len(r.prompt), lambda r: r.out_len,
                lambda r: str(r.adapter)):
        assert sorted(map(key, a)) == sorted(map(key, b))
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    gaps = lambda rs: sorted(np.round(np.diff([r.due for r in rs]), 9))
    if spec["arrivals"]["kind"] == "gamma":
        # the last gap runs past the last arrival, out of the diffs
        assert len(set(gaps(a)) ^ set(gaps(b))) <= 2
        assert len(a) == round(spec["arrivals"]["rate"] * 30.0)
        assert a[-1].due < 30.0


def test_lengths_and_shares_follow_the_mix():
    spec = manifest.traffic("opt-lora-chat")
    reqs = traffic.make(spec, 7, 40.0, 50272)
    plen = np.array([len(r.prompt) for r in reqs])
    assert plen.min() >= 32 and plen.max() <= 1536
    assert abs(np.median(plen) - 384) <= 8
    n = len(reqs)
    for name, share in spec["adapters"].items():
        got = sum(1 for r in reqs if (r.adapter or "base") == name)
        assert abs(got - share * n) <= 1
    dues = np.array([r.due for r in reqs])
    assert np.all(np.diff(dues) >= 0)
    assert n == round(spec["arrivals"]["rate"] * 40.0)
    assert 0.0 == dues[0] and dues[-1] < 40.0


def test_gamma_gaps_have_the_stated_burstiness():
    g = traffic.gamma_gaps(2.0, 20000, 5000.0)
    assert g.mean() == pytest.approx(0.25)
    assert g.var() / g.mean() ** 2 == pytest.approx(2.0, rel=0.1)


def test_the_order_is_uniform_so_bursts_fall_anywhere():
    """Where the shortest gap, the shortest prompt and a lora3 request fall
    is spread evenly over the window across seeds (a stratified order
    would pin their shares to every block)."""
    spec = manifest.traffic("opt-lora-chat")
    n_seeds, quarters = 400, np.zeros((3, 4))
    for seed in range(n_seeds):
        reqs = traffic.make(spec, 2 ** 31 + seed, 51.0, 50272)
        n = len(reqs)
        gaps = np.diff([r.due for r in reqs])
        plen = [len(r.prompt) for r in reqs]
        assert plen.count(min(plen)) == 1
        at = (int(np.argmin(gaps)), int(np.argmin(plen)),
              next(i for i, r in enumerate(reqs) if r.adapter == "lora3"))
        for k, i in enumerate(at[:2]):
            quarters[k, min(3, 4 * i // n)] += 1
        quarters[2, min(3, 4 * at[2] // n)] += 1
    # the first lora3 request is most often early; the other two are even
    for row in quarters[:2]:
        assert np.all(np.abs(row - n_seeds / 4) < 4 * np.sqrt(n_seeds / 4))
    assert quarters[2, 0] > n_seeds / 4


def test_one_adapter_can_come_in_a_run():
    """Runs of one adapter's requests happen, as with independent draws."""
    spec = manifest.traffic("opt-lora-chat")
    longest = 0
    for seed in range(50):
        names = [str(r.adapter) for r in
                 traffic.make(spec, seed, 51.0, 50272)]
        run = 1
        for a, b in zip(names, names[1:]):
            run = run + 1 if a == b == "lora0" else 1
            longest = max(longest, run)
    assert longest >= 4
