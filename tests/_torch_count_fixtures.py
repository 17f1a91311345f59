"""Inputs that the count kernels' tests share (B1 ``dense_count`` and B2
``bitap_count``; ``test_torch_count_segments.py`` on the CPU and
``test_torch_gpu.py`` on the card): needles of two, three and eight bitap
words and of dense packing 2, the IgnoreCase needles of the trap layouts,
and the trap encodings written across segment cuts."""

import numpy as np

from alfred_margaret_tpu_torch.kernels.segments import segment_schedule

V2 = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
V3 = V2 + ["hotel", "india", "juliett"]
_RNG8 = np.random.default_rng(5)
V8 = list(dict.fromkeys("".join(chr(97 + c) for c in _RNG8.integers(0, 26, size=6))
                        for _ in range(30)))
PACK2 = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]).decode() for i in range(30)]
#: IgnoreCase needles: an embedded trap with İ, Kelvin K and ẞ tracks, and a
#: trap register beside one bitap word and beside two.
EMBEDDED_KSS = ["kilo", "straße", "fix"]
REGISTER = ["tshirt", "shirts", "shorts", "kilo", "café"]
REGISTER_V3 = REGISTER + ["alpha", "bravo", "charlie", "delta"]
#: İ, Kelvin K and ẞ: unlowerings that change the byte length (trap tracks).
I_DOT, KELVIN, SHARP_S = "\u0130", "\u212a", "\u1e9e"
CI_TRAPS = (I_DOT, KELVIN, SHARP_S)


def plant_traps(a: np.ndarray, k: int, K: int, traps=CI_TRAPS) -> list:
    """Write each of ``traps`` across each cut of ``k`` segments of overlap
    ``K`` (mid-stream for one segment) into ``a`` (uint8 [T, S], in place):
    trap j of cut i in stream 3i + j (mod S).  Returns the streams written."""
    T, S = a.shape
    cuts = [lo for _, lo, _ in segment_schedule(T, k, K)[1:]] or [T // 2]
    planted = []
    for i, p in enumerate(cuts):
        for j, enc in enumerate(traps):
            b = np.frombuffer(enc.encode(), np.uint8)
            if 1 <= p and p - 1 + len(b) <= T:
                s = (3 * i + j) % S
                a[p - 1:p - 1 + len(b), s] = b
                planted.append(s)
    return planted
