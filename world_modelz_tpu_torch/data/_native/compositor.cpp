// Native frame-compositing kernels for the host data pipeline.
//
// A copy of the JAX package's data/_native/compositor.cpp (the port keeps
// its own). world_modelz_tpu_torch/data/native.py builds it with g++ at
// first use into build/native/ at the repository root and binds it through
// ctypes; its numpy path gives the same bytes when no compiler is found.
// Control logic (bounce dynamics, RNG, trajectory state) stays in Python:
// only the O(T * K^2) / O(T * H * W) pixel work crosses the boundary.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Additive sprite compositing over a clip (the MovingMNIST inner loop,
// data/moving_mnist.py): frames (T, H, W) float32 += digit (K, K) at
// per-frame top-left positions (T, 2) int32 (y, x), with clipping and
// saturation at 1.0 applied by the caller.
void composite_sprite(
    float* frames, int T, int H, int W,
    const float* sprite, int K,
    const int32_t* pos_yx
) {
    for (int t = 0; t < T; ++t) {
        const int sy = pos_yx[2 * t];
        const int sx = pos_yx[2 * t + 1];
        const int y0 = std::max(0, sy), y1 = std::min(H, sy + K);
        const int x0 = std::max(0, sx), x1 = std::min(W, sx + K);
        float* frame = frames + (size_t)t * H * W;
        for (int y = y0; y < y1; ++y) {
            float* row = frame + (size_t)y * W;
            const float* srow = sprite + (size_t)(y - sy) * K;
            for (int x = x0; x < x1; ++x) {
                row[x] += srow[x - sx];
            }
        }
    }
}

// Clamp a clip to [0, 1] in place.
void clamp01(float* frames, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        frames[i] = frames[i] < 0.f ? 0.f : (frames[i] > 1.f ? 1.f : frames[i]);
    }
}

// Scrolling-background + colored-rectangle renderer (the
// SyntheticTrajectorySource frame loop, data/trajectory.py):
// out (T, H, W, 3) uint8; bg (H, 2W, 3) float32; shifts (T,) int32
// horizontal scroll; rects (T, N, 6) float32 rows of
// (y0, x0, size, r, g, b) per frame.
void render_trajectory(
    uint8_t* out, int T, int H, int W,
    const float* bg,
    const int32_t* shifts,
    const float* rects, int N
) {
    const int BW = 2 * W;
    for (int t = 0; t < T; ++t) {
        uint8_t* frame = out + (size_t)t * H * W * 3;
        const int shift = shifts[t] % W;
        // background: bg[:, shift : shift + W]
        for (int y = 0; y < H; ++y) {
            const float* brow = bg + ((size_t)y * BW + shift) * 3;
            uint8_t* orow = frame + (size_t)y * W * 3;
            for (int x = 0; x < W * 3; ++x) {
                float v = brow[x];
                orow[x] = (uint8_t)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
            }
        }
        // rectangles
        const float* fr = rects + (size_t)t * N * 6;
        for (int i = 0; i < N; ++i) {
            const int ry = (int)fr[i * 6 + 0];
            const int rx = (int)fr[i * 6 + 1];
            const int k = (int)fr[i * 6 + 2];
            const uint8_t c0 = (uint8_t)fr[i * 6 + 3];
            const uint8_t c1 = (uint8_t)fr[i * 6 + 4];
            const uint8_t c2 = (uint8_t)fr[i * 6 + 5];
            const int y0 = std::max(0, ry), y1 = std::min(H, ry + k);
            const int x0 = std::max(0, rx), x1 = std::min(W, rx + k);
            for (int y = y0; y < y1; ++y) {
                uint8_t* row = frame + ((size_t)y * W + x0) * 3;
                for (int x = x0; x < x1; ++x) {
                    *row++ = c0;
                    *row++ = c1;
                    *row++ = c2;
                }
            }
        }
    }
}

}  // extern "C"
