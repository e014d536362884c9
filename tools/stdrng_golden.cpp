// Golden-value generator for the libstdc++ RNG twins in
// cunvsm/data/stdrng.py (the reference's host RNG machinery:
// /root/reference/include/cuNVSM/base.h:36 typedef std::minstd_rand0 RNG;
// cpp/labels.cu:3-22 negative sampling; cpp/data_indri.cpp:385-397
// position draws + std::shuffle; cuda_utils.h:24-33 uniform ints +
// Glorot via generate_canonical).
//
// Build + run:  g++ -O2 -std=c++14 -o /tmp/stdrng_golden tools/stdrng_golden.cpp
// Output: one JSON-ish line per section; values are pinned in
// tests/test_stdrng.py so the Python twins are bit-checked against real
// libstdc++ without needing a compiler at test time.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <random>
#include <vector>

static void print_vec(const char* name, const std::vector<long long>& v) {
    std::printf("%s = [", name);
    for (size_t i = 0; i < v.size(); ++i)
        std::printf("%s%lld", i ? ", " : "", v[i]);
    std::printf("]\n");
}

int main() {
    // 1. Raw engine draws, seed 1 and seed 12345.
    for (unsigned seed : {1u, 12345u}) {
        std::minstd_rand0 g(seed);
        std::vector<long long> out;
        for (int i = 0; i < 8; ++i) out.push_back((long long)g());
        std::printf("raw_seed%u", seed);
        print_vec("", out);
    }

    // 2. uniform_int_distribution over assorted ranges, seed 1
    //    (cuda_utils.h:24-33 generate_random_indexes uses a fresh
    //    distribution object per call site; distributions are stateless
    //    for these params).
    {
        std::minstd_rand0 g(1);
        std::vector<long long> out;
        for (int rep = 0; rep < 4; ++rep) {
            out.push_back(std::uniform_int_distribution<int>(0, 9)(g));
            out.push_back(std::uniform_int_distribution<int>(0, 0)(g));
            out.push_back(std::uniform_int_distribution<int>(0, 261143)(g));
            out.push_back(std::uniform_int_distribution<int>(5, 7)(g));
            out.push_back(
                std::uniform_int_distribution<int>(0, 2147483645)(g));
        }
        print_vec("uniform_ints_seed1", out);
    }

    // 3. std::shuffle of iota(n), seed 7: n=10 & n=13 exercise the
    //    paired-swap fast path (urange^2 <= urngrange), n=50000 the
    //    per-element fallback.
    for (int n : {10, 13, 50000}) {
        std::minstd_rand0 g(7);
        std::vector<long long> v(n);
        for (int i = 0; i < n; ++i) v[i] = i;
        std::shuffle(v.begin(), v.end(), g);
        if (n <= 13) {
            std::printf("shuffle%d_seed7", n);
            print_vec("", v);
        } else {
            long long h = 0;
            for (int i = 0; i < n; ++i) h = (h * 1000003 + v[i]) % 1000000007;
            std::vector<long long> head(v.begin(), v.begin() + 8);
            std::printf("shuffle%d_seed7_head", n);
            print_vec("", head);
            std::printf("shuffle%d_seed7_hash = %lld\n", n, h);
        }
    }

    // 4. generate_canonical<float,1> (init_matrix_glorot's element draw,
    //    cuda_utils.h:35-47), seed 3 — printed as the exact bit pattern.
    {
        std::minstd_rand0 g(3);
        std::vector<long long> out;
        for (int i = 0; i < 8; ++i) {
            float f = std::generate_canonical<float, 1>(g);
            unsigned int bits;
            __builtin_memcpy(&bits, &f, 4);
            out.push_back((long long)bits);
        }
        print_vec("canonical_f32_bits_seed3", out);
    }

    // 5. The reference's exact negative-label consumption
    //    (labels.cu:3-22): per instance, k draws of
    //    uniform_int_distribution<int>(0, num_entities-1); stream shared
    //    with everything else.  Seed 1, 4 instances, k=3, 100 entities.
    {
        std::minstd_rand0 g(1);
        std::vector<long long> out;
        for (int idx = 0; idx < 4; ++idx)
            for (int k = 0; k < 3; ++k)
                out.push_back(
                    std::uniform_int_distribution<int>(0, 99)(g));
        print_vec("labels_seed1_e100_k3", out);
    }
    return 0;
}
