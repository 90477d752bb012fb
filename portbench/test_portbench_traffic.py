"""The generators: shapes fixed by the traffic file, ids drawn from the
seed."""

import itertools
import json
from statistics import NormalDist

import numpy as np
import pytest

from portbench import traffic
from portbench.conftest import PACKAGE
from portbench.drivers.batched_prefill import Sample, arrivals

TRAIN = json.loads((PACKAGE / "traffic" / "train-4k.json").read_text())
SHORT = json.loads((PACKAGE / "traffic" / "prefill-short.json").read_text())
TAIL = json.loads((PACKAGE / "traffic" / "prefill-short-tail.json").read_text())


def docs(seed, n=200):
    return list(itertools.islice(traffic.documents(TRAIN["documents"], 50280, seed), n))


def test_lengths_from_the_file_ids_from_the_seed():
    a, b, a2 = docs(1), docs(2 ** 31 + 5), docs(1)
    assert [len(x) for x in a] == [len(x) for x in b]
    assert all(np.array_equal(x, y) for x, y in zip(a, a2))
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(x.dtype == np.int32 and x.min() >= 0 and x.max() < 50280 for x in a)


def test_the_law():
    law = TRAIN["documents"]
    n = np.array(list(itertools.islice(traffic.document_lengths(law), 20000)))
    assert n.min() >= law["min_len"] and n.max() <= law["max_len"]
    assert abs(n.mean() / law["mean_len"] - 1) < 0.05
    d = docs(3, 50)
    long = [x for x in d if len(x) >= 32]
    assert all((np.lib.stride_tricks.sliding_window_view(x, 8) == x[:8]).all(1).sum() >= 2
               for x in long)


def test_large_and_negative_seeds():
    for s in (2 ** 31 + 1, 2 ** 40, -3):
        assert len(traffic.prompt_ids([5, 7], 100, s)) == 2


def test_prompt_lengths_are_the_quantiles():
    """The 64 mid-quantiles of the file's log-normal law below its cap."""
    law, z = SHORT["prompt_law"], NormalDist()
    top = z.cdf(np.log(law["max_len"] / law["median"]) / law["sigma"])
    q = [int(round(law["median"] * np.exp(law["sigma"] * z.inv_cdf((i + 0.5) / 64 * top))))
         for i in range(64)]
    assert sorted(SHORT["prompt_lengths"]) == q and q[-1] <= law["max_len"]
    assert SHORT["prompt_lengths"] == [q[i] for i in np.random.default_rng(0).permutation(64)]
    assert TAIL["prompt_lengths"] == SHORT["prompt_lengths"]


def test_arrivals_fixed_by_the_file():
    a, b = arrivals(SHORT, 30), arrivals(SHORT, 4)
    assert np.array_equal(a[:len(b)], b) and b[-1] < 4 <= a[len(b)]
    burst = SHORT["arrival_burst"]
    assert burst == SHORT["batch"] and not a[:burst + 1].any()
    assert np.all(np.diff(a[burst:]) > 0) and a[-1] < 30


@pytest.mark.parametrize("tr", [SHORT, TAIL], ids=["poisson", "bursty"])
def test_arrivals_rate_and_burstiness(tr):
    """The gaps' mean is one over the rate, their coefficient of variation
    the file's (1 for Poisson)."""
    gaps = np.diff(arrivals(tr, 20000 / tr["arrival_rate"])[tr["arrival_burst"]:])
    assert abs(gaps.mean() * tr["arrival_rate"] - 1) < 0.05
    assert abs(gaps.std() / gaps.mean() / tr["arrival_cv"] - 1) < 0.1


def test_prompt_ids_from_the_seed():
    a = traffic.prompt_ids([5, 9], 1000, 11, 0)
    b = traffic.prompt_ids([5, 9], 1000, 12, 0)
    assert [len(x) for x in a] == [5, 9]
    assert not np.array_equal(a[1], b[1])
    assert np.array_equal(a[1], traffic.prompt_ids([5, 9], 1000, 11, 0)[1])


@pytest.mark.parametrize("seed", [0, 1, 2 ** 33])
def test_the_check_keeps_the_longest_each_size_and_draws(seed):
    """The longest prompt's batch is kept past the budget; the first batch
    of each size and the drawn ones only within it; one seed, one sample."""
    tr = dict(TAIL, check_share=0.5, check_tokens=6000)
    L = tr["prompt_lengths"]
    longest = int(np.argmax(L))
    batches, k = [], 0
    for n in itertools.cycle([3, 1, 2]):
        if k >= 200:
            break
        batches.append(list(range(k, min(k + n, 200))))
        k += n

    def picks():
        s = Sample(tr, seed)
        return [b for b in batches if s.keep(b[0], [L[i % len(L)] for i in b])]
    kept = picks()
    assert kept == picks()
    assert any(longest in b for b in kept)
    assert {len(b) for b in kept} == {1, 2, 3}
    rest = [b for b in kept if longest not in b]
    assert sum(L[i % len(L)] for b in rest for i in b) <= tr["check_tokens"]
    assert len(rest) < len(batches)
