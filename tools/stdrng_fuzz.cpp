// Parameterized libstdc++ RNG driver for differential fuzzing of the
// Python twins in cunvsm/data/stdrng.py (tests/test_stdrng.py
// compiles and runs this live when g++ is available, on top of the
// pinned goldens from stdrng_golden.cpp).
//
//   stdrng_fuzz raw     <seed> <n>
//   stdrng_fuzz uniform <seed> <lo> <hi> <n>      (fresh dist per draw)
//   stdrng_fuzz shuffle <seed> <n>
//   stdrng_fuzz canon   <seed> <n>                (float32 bit patterns)
//   stdrng_fuzz glorot  <seed> <rows> <cols>      (init_matrix_glorot bits:
//                                                  2*max*(canonical<f,1>-0.5),
//                                                  max=sqrt(6.0/(rows+cols)),
//                                                  cuda_utils.h:35-47)
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

int main(int argc, char** argv) {
    if (argc < 3) return 2;
    const char* mode = argv[1];
    unsigned seed = (unsigned)strtoul(argv[2], nullptr, 10);
    std::minstd_rand0 g(seed);
    if (!strcmp(mode, "raw")) {
        int n = atoi(argv[3]);
        for (int i = 0; i < n; ++i) std::printf("%llu\n", (unsigned long long)g());
    } else if (!strcmp(mode, "uniform")) {
        long long lo = atoll(argv[3]), hi = atoll(argv[4]);
        int n = atoi(argv[5]);
        for (int i = 0; i < n; ++i) {
            std::uniform_int_distribution<long long> d(lo, hi);
            std::printf("%lld\n", d(g));
        }
    } else if (!strcmp(mode, "shuffle")) {
        int n = atoi(argv[3]);
        std::vector<long long> v(n);
        for (int i = 0; i < n; ++i) v[i] = i;
        std::shuffle(v.begin(), v.end(), g);
        for (auto x : v) std::printf("%lld\n", x);
    } else if (!strcmp(mode, "canon")) {
        int n = atoi(argv[3]);
        for (int i = 0; i < n; ++i) {
            float f = std::generate_canonical<float,
                std::numeric_limits<float>::digits>(g);
            uint32_t bits;
            std::memcpy(&bits, &f, 4);
            std::printf("%u\n", bits);
        }
    } else if (!strcmp(mode, "glorot")) {
        int rows = atoi(argv[3]), cols = atoi(argv[4]);
        const float max = sqrt(6.0 / (rows + cols));
        for (int i = 0; i < rows * cols; ++i) {
            // Exactly init_matrix_glorot's expression (cuda_utils.h:44-47):
            // float - double promotes the product to double, one f32
            // rounding at the assignment.
            float v = 2 * max * (std::generate_canonical<float, 1>(g) - 0.5);
            uint32_t bits;
            std::memcpy(&bits, &v, 4);
            std::printf("%u\n", bits);
        }
    } else {
        return 2;
    }
    return 0;
}
