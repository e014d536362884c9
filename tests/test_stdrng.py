"""Bit-level validation of the libstdc++ RNG twins (data/stdrng.py).

Golden values were produced by real libstdc++ via tools/stdrng_golden.cpp
(g++ -O2 -std=c++14), mirroring the reference's exact consumption patterns:
minstd_rand0 (/root/reference/include/cuNVSM/base.h:36), uniform ints
(cuda_utils.h:24-33), the instance shuffle (cpp/data_indri.cpp:397), Glorot
canonical draws (cuda_utils.h:35-47), and the negative-label stream
(cpp/labels.cu:3-22).  If these pass, a reference_rng training run draws
bit-identical instance orders and label streams to the CUDA binary.
"""

import struct

import numpy as np

from cunvsm.data.stdrng import (
    MinstdRand0,
    generate_canonical_f32,
    glorot_uniform_f32,
    reference_negative_labels,
    std_shuffle,
    uniform_int,
)

RAW_SEED1 = [16807, 282475249, 1622650073, 984943658, 1144108930,
             470211272, 101027544, 1457850878]
RAW_SEED12345 = [207482415, 1790989824, 2035175616, 77048696, 24794531,
                 109854999, 1644515420, 1256127050]
UNIFORM_INTS_SEED1 = [0, 0, 197330, 6, 1144108929, 2, 0, 177289, 7,
                      2007237708, 3, 0, 217011, 5, 114807986, 5, 0, 2010,
                      6, 143542611]
SHUFFLE10_SEED7 = [1, 6, 5, 7, 0, 9, 8, 3, 4, 2]
SHUFFLE13_SEED7 = [2, 7, 1, 10, 3, 12, 11, 9, 0, 5, 4, 8, 6]
SHUFFLE50000_SEED7_HEAD = [14719, 37942, 36763, 25438, 32228, 4954, 45809,
                           40940]
SHUFFLE50000_SEED7_HASH = 997432716
CANONICAL_F32_BITS_SEED3 = [935654400, 1053428419, 1049140250, 1052802194,
                            1058613837, 1059596577, 1041270116, 1024844735]
LABELS_SEED1_E100_K3 = [0, 13, 75, 45, 53, 21, 4, 67, 67, 93, 38, 51]


def test_raw_engine():
    for seed, want in ((1, RAW_SEED1), (12345, RAW_SEED12345)):
        g = MinstdRand0(seed)
        assert [g() for _ in range(8)] == want


def test_seed_zero_maps_to_one():
    assert MinstdRand0(0).state == 1
    assert MinstdRand0(2147483647).state == 1


def test_uniform_int_distribution():
    g = MinstdRand0(1)
    got = []
    for _ in range(4):
        got.append(uniform_int(g, 0, 9))
        got.append(uniform_int(g, 0, 0))
        got.append(uniform_int(g, 0, 261143))
        got.append(uniform_int(g, 5, 7))
        got.append(uniform_int(g, 0, 2147483645))
    assert got == UNIFORM_INTS_SEED1


def test_std_shuffle_paired_fast_path():
    for n, want in ((10, SHUFFLE10_SEED7), (13, SHUFFLE13_SEED7)):
        g = MinstdRand0(7)
        v = list(range(n))
        std_shuffle(v, g)
        assert v == want


def test_std_shuffle_per_element_fallback():
    g = MinstdRand0(7)
    v = list(range(50000))
    std_shuffle(v, g)
    assert v[:8] == SHUFFLE50000_SEED7_HEAD
    h = 0
    for x in v:
        h = (h * 1000003 + x) % 1000000007
    assert h == SHUFFLE50000_SEED7_HASH


def test_generate_canonical_f32_bits():
    g = MinstdRand0(3)
    got = [
        struct.unpack("<I", struct.pack("<f", generate_canonical_f32(g)))[0]
        for _ in range(8)
    ]
    assert got == CANONICAL_F32_BITS_SEED3


def test_reference_negative_label_stream():
    g = MinstdRand0(1)
    rows = reference_negative_labels(g, [0, 1, 2, 3], 100, 3)
    assert [x for row in rows for x in row] == LABELS_SEED1_E100_K3


def test_discard_matches_sequential():
    g1, g2 = MinstdRand0(42), MinstdRand0(42)
    for _ in range(1337):
        g1()
    g2.discard(1337)
    assert g1.state == g2.state


def test_glorot_range():
    g = MinstdRand0(3)
    vals = np.asarray(glorot_uniform_f32(g, 30, 20))
    mx = np.sqrt(6.0 / 50)
    assert np.all(np.abs(vals) <= mx)
    assert np.std(vals) > 0.1 * mx


def test_differential_fuzz_against_live_gplusplus(tmp_path):
    # On top of the pinned goldens: compile tools/stdrng_fuzz.cpp with the
    # real g++ and compare the twins across random seeds and parameter
    # ranges (skipped where no compiler exists).
    import shutil
    import subprocess

    if not shutil.which("g++"):
        import pytest

        pytest.skip("g++ not available")
    exe = str(tmp_path / "fuzz")
    subprocess.run(
        ["g++", "-O2", "-std=c++14", "-o", exe, "tools/stdrng_fuzz.cpp"],
        check=True, cwd=__file__.rsplit("/tests/", 1)[0],
    )

    def run(*args):
        out = subprocess.run(
            [exe] + [str(a) for a in args],
            check=True, capture_output=True, text=True,
        ).stdout.split()
        return [int(x) for x in out]

    rng = np.random.RandomState(99)
    for _ in range(6):
        seed = int(rng.randint(1, 2**31 - 1))
        n = int(rng.randint(3, 40))
        g = MinstdRand0(seed)
        assert [g() for _ in range(n)] == run("raw", seed, n)

        lo = int(rng.randint(0, 1000))
        hi = lo + int(rng.randint(0, 2**20))
        g = MinstdRand0(seed)
        assert uniform_int(g, lo, hi) == run("uniform", seed, lo, hi, 1)[0]
        g = MinstdRand0(seed)
        got = [uniform_int(g, lo, hi) for _ in range(n)]
        assert got == run("uniform", seed, lo, hi, n)

        m = int(rng.randint(2, 200))
        seq = list(range(m))
        g = MinstdRand0(seed)
        std_shuffle(seq, g)
        assert seq == run("shuffle", seed, m)

        g = MinstdRand0(seed)
        bits = [
            struct.unpack("I", struct.pack("f", generate_canonical_f32(g)))[0]
            for _ in range(n)
        ]
        assert bits == run("canon", seed, n)

        # init_matrix_glorot's exact expression, incl. the float-double
        # promotion of (canonical - 0.5) — see glorot_uniform_f32.
        rows = int(rng.randint(1, 50))
        cols = int(rng.randint(1, 50))
        g = MinstdRand0(seed)
        bits = [
            struct.unpack("I", struct.pack("f", v))[0]
            for v in glorot_uniform_f32(g, rows, cols)
        ]
        assert bits == run("glorot", seed, rows, cols)


def test_lcg_block_matches_scalar():
    from cunvsm.data.stdrng import _lcg_block

    g = MinstdRand0(42)
    assert list(_lcg_block(MinstdRand0(42).state, 500)) == [
        g() for _ in range(500)
    ]


def test_fast_forward_uniform_draws_exact():
    """The vectorized skip leaves the engine exactly where the scalar
    rejection-sampling loop leaves it — mixed ranges, a high-rejection
    constant range (uerange ~2e9 rejects ~7% of raws), and both
    std_shuffle consumption paths (paired-swap and linear)."""
    from cunvsm.data.stdrng import (
        fast_forward_uniform_draws,
        past_threshold,
        shuffle_draw_pasts,
    )

    rng = np.random.RandomState(0)
    for seed in (1, 7, 123456):
        his = rng.randint(0, 3_000_000, 3000)
        g1, g2 = MinstdRand0(seed), MinstdRand0(seed)
        for hi in his:
            uniform_int(g1, 0, int(hi))
        fast_forward_uniform_draws(
            g2, np.asarray([past_threshold(int(h) + 1) for h in his])
        )
        assert g1.state == g2.state

    g1, g2 = MinstdRand0(3), MinstdRand0(3)
    hi = 2_000_000_000
    for _ in range(2000):
        uniform_int(g1, 0, hi)
    fast_forward_uniform_draws(
        g2, np.full(2000, past_threshold(hi + 1), np.int64)
    )
    assert g1.state == g2.state

    for n in (2, 3, 17, 100, 46340, 46341, 50001):
        g1, g2 = MinstdRand0(9), MinstdRand0(9)
        std_shuffle(list(range(n)), g1)
        fast_forward_uniform_draws(g2, shuffle_draw_pasts(n))
        assert g1.state == g2.state, n
