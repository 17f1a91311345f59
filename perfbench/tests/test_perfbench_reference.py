"""The plain reference against ``bytes.find``, the control, and the
configurations' needle sets."""

import json
import os
import random

import numpy as np
import pytest

from perfbench import reference
from perfbench.corpus import generate, to_host_bytes

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("trial", range(12))
@pytest.mark.parametrize("alphabet,longest", [(b"abc ", 5), (b"\x00\x7f\x80\xff", 12)])
def test_reference_equals_find_across_block_seams(trial, alphabet, longest):
    """Short needles (compared as one packed integer, sign bit included)
    and long ones (byte by byte), duplicates included."""
    rng = random.Random(trial)
    data = bytes(rng.choice(alphabet) for _ in range(rng.randint(0, 3000)))
    needles = [bytes(rng.choice(alphabet[:3]) for _ in range(rng.randint(1, longest)))
               for _ in range(rng.randint(1, 6))]
    needles.append(needles[0])
    want = reference.naive_count(data, needles)
    for block in (1, 2, 7, 64, 1000, 1 << 20):
        assert reference.count(data, needles, "cpu", block=block) == want


@pytest.mark.parametrize("name", ["ref3", "c100"])
def test_reference_on_the_generated_text(name):
    needles = [n.encode() for n in _config(name)["needles"]]
    data = to_host_bytes(generate((1 << 18) + 12345, needles, 11, hit_fraction=0.01,
                                  word_min=3, word_max=9, device="cpu"))
    want = reference.naive_count(data, needles)
    assert want > 0
    assert reference.count(data, needles, "cpu", block=4099) == want


@pytest.mark.parametrize("trial", range(6))
def test_control_is_the_count_of_independent_blocks(trial):
    rng = random.Random(100 + trial)
    data = bytes(rng.choice(b"ab") for _ in range(2000))
    needles = [b"ab", b"bab", b"a"]
    cut = rng.randint(1, 40)
    want = sum(reference.naive_count(data[i : i + cut], needles) for i in range(0, len(data), cut))
    assert reference.count(data, needles, "cpu", block=333, cut=cut) == want


def test_c100_is_config_2s_draw():
    """The needle list in ``configs/c100.json`` is
    ``alfred_margaret_tpu_torch/bench/configs.py:config2_needles``'s draw,
    repeated here from its definition."""
    rng = np.random.default_rng(7)
    words = ("".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
             for _ in range(110))
    draw = list(dict.fromkeys(words))[:100]
    draw[:4] = ["abc", "abcd", "bcd", "c"]
    needles = _config("c100")["needles"]
    assert needles == draw and len(set(needles)) == 100
    assert _config("ref3")["needles"] == ["tshirt", "shirts", "shorts"]
