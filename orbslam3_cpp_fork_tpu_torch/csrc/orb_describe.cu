// Fused ORB "describe" for Hopper (sm_90a): keypoints -> IC angle, steered
// BRIEF bits and packed descriptor words, all pyramid levels in one launch.
//
// Redesign of what the TPU kernel orbslam3_cpp_fork_tpu/ops/patches.py:
// _patch_kernel (pallas_call in _extract_patches_tpu) and its two matmul
// consumers (ic_angle_from_patches, brief_from_patches) compute together.
// On the TPU the 40x40 patches had to reach memory, because the next stage
// was a matrix-unit product. Here the consumers are a 709-tap moment sum
// and 256 two-pixel compares, so the window never leaves the block:
//
//   angle[i]   = atan2(m01, m10), the radius-15 circular moments of the raw
//                level around keypoint i (edge-clamped reads);
//   bits[i, k] = bf16(I_blur(b_k)) > bf16(I_blur(a_k)), pair k rotated to
//                the 12-degree bin of angle[i], reads edge-clamped in the
//                40x40 window with the keypoint at [19, 19];
//   words[i,j] = bits[i, 32 j .. 32 j + 31] packed, bit 0 first.
//
// Mapping: one block of 128 threads per keypoint. The block finds its
// level from the start offsets in the level table (passed by value as a
// kernel argument: no upload, no sync, capturable in a CUDA graph), stages
// the blurred window in shared memory already rounded to bf16 (3.2 KB),
// and sums the moments from the raw level in float64 (warp shuffles, then
// one shared-memory step in a fixed order, so the sum is deterministic and
// rounded to float32 once). Each thread then looks up two pairs' window
// indices for the block's bin and compares; __ballot_sync over pairs
// 32 j .. 32 j + 31 gives word j directly in the required bit order.
// 128 threads let 16 blocks share an SM, so the 1247 blocks of a frame run
// as one wave on 132 SMs; with 256 threads (two waves) the kernel took
// 10.5 us instead of 8.8 us on an H100 at 700 W (chip_smoke.py --profile).
//
// What bounds it on this card: bytes. A frame at 752x480 with 1000
// features reads both pyramids once (~8.9 MB, small enough for the 50 MB
// L2) plus the 30 KB pair table and writes 1247 x
// 324 B ~= 0.4 MB: about 2.8 us at 3.35 TB/s. No patch tensor (16 MB a
// frame on the per-level route) is written at all.
//
// The first thread of the grid adds one to a device-side counter, so the
// count is of launches that ran, eager or replayed from a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kRad = 19;         // keypoint position in the window
constexpr int kPatch = 40;       // window rows and columns
constexpr int kHalfPatch = 15;   // IC_Angle radius
constexpr int kMomentSide = 2 * kHalfPatch + 1;
constexpr int kBins = 30;
constexpr int kPairs = 256;      // BRIEF pairs = descriptor bits
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// float(30 / (2 pi)): the plain version multiplies by this f32 constant.
constexpr float kBinScale = 4.7746482927568605f;

}  // namespace

// Mirrors ops/_kernels.py:LevelTable field for field.
struct LevelTable {
  const float* raw[kMaxLevels];
  const float* blur[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels + 1];  // keypoints of level l are [start[l], start[l+1])
  int n_levels;
};

namespace {

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const LevelTable t, const int* __restrict__ xy,
                    const uint16_t* __restrict__ pairs,
                    float* __restrict__ angle, int8_t* __restrict__ bits,
                    long long* __restrict__ words,
                    unsigned long long* __restrict__ counter) {
  __shared__ __nv_bfloat16 win[kPatch * kPatch];
  __shared__ double red[2][kWarps];
  __shared__ int s_bin;

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (i == 0 && tid == 0) atomicAdd(counter, 1ULL);

  int l = 0;
  while (l + 1 < t.n_levels && i >= t.start[l + 1]) ++l;
  const int h = t.h[l];
  const int w = t.w[l];
  const float* __restrict__ raw = t.raw[l];
  const float* __restrict__ blur = t.blur[l];
  // The keypoint is clipped into the image first, then every read.
  const int x = min(max(xy[2 * i], 0), w - 1);
  const int y = min(max(xy[2 * i + 1], 0), h - 1);

  for (int p = tid; p < kPatch * kPatch; p += kThreads) {
    const int yy = min(max(y + p / kPatch - kRad, 0), h - 1);
    const int xx = min(max(x + p % kPatch - kRad, 0), w - 1);
    win[p] = __float2bfloat16_rn(__ldg(blur + static_cast<size_t>(yy) * w + xx));
  }

  double m10 = 0.0, m01 = 0.0;
  for (int p = tid; p < kMomentSide * kMomentSide; p += kThreads) {
    const int dy = p / kMomentSide - kHalfPatch;
    const int dx = p % kMomentSide - kHalfPatch;
    if (dx * dx + dy * dy <= kHalfPatch * kHalfPatch + kHalfPatch) {
      const int yy = min(max(y + dy, 0), h - 1);
      const int xx = min(max(x + dx, 0), w - 1);
      const double v = __ldg(raw + static_cast<size_t>(yy) * w + xx);
      m10 += v * dx;
      m01 += v * dy;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_down_sync(0xffffffffu, m10, off);
    m01 += __shfl_down_sync(0xffffffffu, m01, off);
  }
  if (lane == 0) {
    red[0][warp] = m10;
    red[1][warp] = m01;
  }
  __syncthreads();  // also publishes win[]
  if (tid == 0) {
    double s10 = 0.0, s01 = 0.0;
    for (int k = 0; k < kWarps; ++k) {
      s10 += red[0][k];
      s01 += red[1][k];
    }
    const float f10 = static_cast<float>(s10);
    const float f01 = static_cast<float>(s01);
    // Flat or padded slots: angle 0 and bin 0, whatever the zeros' signs.
    const float a = (f10 == 0.0f && f01 == 0.0f) ? 0.0f : atan2f(f01, f10);
    angle[i] = a;
    const int b = static_cast<int>(rintf(a * kBinScale)) % kBins;  // half to even
    s_bin = b < 0 ? b + kBins : b;
  }
  __syncthreads();

  const uint16_t* __restrict__ pr = pairs + static_cast<size_t>(s_bin) * kPairs * 2;
  for (int k = tid; k < kPairs; k += kThreads) {
    const bool bit = __bfloat162float(win[pr[2 * k + 1]]) > __bfloat162float(win[pr[2 * k]]);
    bits[static_cast<size_t>(i) * kPairs + k] = bit ? 1 : 0;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) words[static_cast<size_t>(i) * (kPairs / 32) + k / 32] = static_cast<long long>(word);
  }
}

}  // namespace

// table: host pointer to the level table (copied into the launch's
// arguments); every level image is contiguous f32 (h, w) on the device.
// xy: contiguous int32 (m, 2) as (x, y), levels concatenated in order.
// pairs: uint16 (30, 256, 2) window indices (a, b) of each rotated pair.
// angle: f32 (m,); bits: int8 (m, 256); words: int64 (m, 8); counter: one
// uint64 on the device. Launches on `stream` and returns the launch's
// cudaError_t (0 on success). Does not synchronise.
extern "C" int orb_describe(const LevelTable* table, const int* xy,
                            const uint16_t* pairs, float* angle, int8_t* bits,
                            long long* words, unsigned long long* counter,
                            int m, void* stream) {
  if (m <= 0) return 0;
  if (table->n_levels < 1 || table->n_levels > kMaxLevels ||
      table->start[table->n_levels] != m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  orb_describe_kernel<<<m, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, xy, pairs, angle, bits, words, counter);
  return static_cast<int>(cudaGetLastError());
}
