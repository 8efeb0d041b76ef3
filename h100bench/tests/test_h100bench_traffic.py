"""The chat traffic is determined by the seed, and every seed serves the
same sizes: the mix fixes them and their order, the seed draws the ids."""

import json

import numpy as np

from h100bench.benchlib.cells import BENCH
from h100bench.tests.tiny import driver

P = json.loads((BENCH / "traffic" / "chat-conv-c64.json").read_text())
BIG = 2**31 + 4_000_000_019


def test_chat_requests_follow_the_seed():
    chat = driver("chat")
    a, b = chat.Traffic(P, BIG, 151_936), chat.Traffic(P, BIG, 151_936)
    for client, j in [(0, 0), (5, 0), (63, 3), (17, 40)]:
        assert a.request(client, j) == b.request(client, j)
    other = chat.Traffic(P, BIG + 1, 151_936)
    assert a.request(3, 2)[0] != other.request(3, 2)[0]


def test_chat_sizes_do_not_change_with_the_seed():
    chat = driver("chat")
    a, b = chat.Traffic(P, 1, 151_936), chat.Traffic(P, BIG, 151_936)
    # Request g = client + clients * j takes pool entry order[g % size]; the
    # pool and its order come from the mix's pool seed, not the run's.
    assert sorted(a.order) == list(range(P["pool"]["size"]))
    for client, j in [(0, 0), (7, 1), (50, 5), (63, 30)]:
        ra, rb = a.request(client, j), b.request(client, j)
        assert len(ra[0]) == len(rb[0]) and ra[1:] == rb[1:]
    c, j = 5, 2
    k = a.order[c + P["clients"] * j]
    assert len(a.request(c, j)[0]) == a.prompt_len[k] and a.request(c, j)[1] == a.budget[k]


def test_chat_lengths_and_greedy_share():
    chat = driver("chat")
    t = chat.Traffic(P, 7, 151_936)
    lens = np.array([len(t.request(c, 1)[0]) for c in range(P["clients"])])
    assert lens.min() >= P["prompt"]["min"] and lens.max() <= P["prompt"]["max"]
    # The source's medians (Splitwise's Azure conversation trace: 1020, 129).
    assert 950 < np.median(t.prompt_len) < 1100 and 115 < np.median(t.budget) < 145
    greedy = [t.request(c, j)[2] for c in range(P["clients"]) for j in range(3)]
    assert abs(sum(greedy) / len(greedy) - 1 / 3) < 0.01
    first = [t.request(c, 0)[1] for c in range(P["clients"])]
    assert min(first) >= 1 and max(first) <= P["output"]["max"]
