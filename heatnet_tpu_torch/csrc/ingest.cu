// Ingest: raw sensor frames -> normalised network input in one pass.
//
// Replaces the Pallas kernels of heatnet_tpu/ops/pallas_preproc.py:
//   _ir_kernel  (:60-65)  uint16 counts -> clamp [21800, 25000] -> [0,1] -> (x-.5)/.5
//   _rgb_kernel (:68-70)  uint8 -> x/255 -> (x-.5)/.5
// and the column crop of inference_preprocess_fused (:111-126), which here is
// a read window instead of a slice of a full-width result. It can also write
// cat([rgb, ir], -1), the 4-channel early-fusion input of ResNeXtSeg
// (heatnet_tpu/models/trgb_segnet.py:215-219), so that tensor is produced
// by ingest and never assembled from two normalised halves.
//
// Bound on the H100: bytes only. Each pixel reads 3 + 2 bytes and writes
// 4 bf16 (8 bytes) and does ~10 flops, far below 295 flops per byte. The
// design keeps every byte to one read and one write: one thread per output
// pixel, neighbouring threads on neighbouring pixels (so reads and the 8- or
// 16-byte vector stores of the fused layout coalesce), and a grid-stride
// loop that masks the ragged tail. The TPU's (rows, 128) lane padding
// (_as_rows, :44-57) is a tiling artifact and has no counterpart here.
//
// The arithmetic is the Pallas kernels' own, in float32 with IEEE division,
// so the plain PyTorch version (ops/fused_preproc.py) agrees to the bit
// before the final rounding to bf16, which both do round-to-nearest-even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kIrMin = 21800.0f;
constexpr float kIrMax = 25000.0f;

__device__ __forceinline__ float rgb_norm(uint8_t v) {
  float x = static_cast<float>(v) * (1.0f / 255.0f);
  return (x - 0.5f) / 0.5f;
}

__device__ __forceinline__ float ir_norm(uint16_t v) {
  float x = fminf(fmaxf(static_cast<float>(v), kIrMin), kIrMax);
  x = (x - kIrMin) / (kIrMax - kIrMin);
  return (x - 0.5f) / 0.5f;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);  // .x = a at the lower address
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// rgb: (rows, w_in, 3) uint8, ir: (rows, w_in) uint16, rows = N*H.
// Output pixel i = row * w_out + col reads column col_lo + col. Each output
// pointer may be null; out_cat is (rows, w_out, 4), out_rgb (.., 3), out_ir (.., 1).
template <typename T>
__global__ void ingest_kernel(const uint8_t* __restrict__ rgb,
                              const uint16_t* __restrict__ ir,
                              T* __restrict__ out_rgb, T* __restrict__ out_ir,
                              T* __restrict__ out_cat, long long n_pix,
                              int w_in, int w_out, int col_lo) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_pix; i += stride) {
    const long long row = i / w_out;
    const long long src = row * w_in + col_lo + (i - row * w_out);
    float r = 0.f, g = 0.f, b = 0.f, t = 0.f;
    if (rgb != nullptr) {
      r = rgb_norm(rgb[src * 3 + 0]);
      g = rgb_norm(rgb[src * 3 + 1]);
      b = rgb_norm(rgb[src * 3 + 2]);
    }
    if (ir != nullptr) t = ir_norm(ir[src]);
    if (out_cat != nullptr) store4(out_cat + i * 4, r, g, b, t);
    if (out_rgb != nullptr) {
      store1(out_rgb + i * 3 + 0, r);
      store1(out_rgb + i * 3 + 1, g);
      store1(out_rgb + i * 3 + 2, b);
    }
    if (out_ir != nullptr) store1(out_ir + i, t);
  }
}

template <typename T>
void launch(const void* rgb, const void* ir, void* out_rgb, void* out_ir,
            void* out_cat, long long rows, int w_in, int col_lo, int col_hi,
            cudaStream_t stream) {
  const int w_out = col_hi - col_lo;
  const long long n_pix = rows * w_out;
  const int threads = 256;
  long long blocks = (n_pix + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 waves of SMs
  if (blocks < 1) blocks = 1;
  ingest_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const uint8_t*>(rgb), static_cast<const uint16_t*>(ir),
      static_cast<T*>(out_rgb), static_cast<T*>(out_ir), static_cast<T*>(out_cat),
      n_pix, w_in, w_out, col_lo);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch; the caller raises if it is not 0.
int hn_ingest(const void* rgb, const void* ir, void* out_rgb, void* out_ir,
              void* out_cat, int out_bf16, long long rows, int w_in, int col_lo,
              int col_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    launch<__nv_bfloat16>(rgb, ir, out_rgb, out_ir, out_cat, rows, w_in, col_lo,
                          col_hi, s);
  } else {
    launch<float>(rgb, ir, out_rgb, out_ir, out_cat, rows, w_in, col_lo, col_hi,
                  s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
