// int8 convolution for the int8 serving mode on Hopper: one quantize pass,
// then an implicit GEMM on int8 wgmma fed by an asynchronous ring, with the
// dequantisation (and, for the grouped convs, bn3's affine + activation) in
// a coalesced epilogue. One C entry (hn_int8_conv) launches both kernels.
//
// Not a TPU kernel. Its JAX counterpart is XLA's
// conv_general_dilated(int8, int8, preferred_element_type=int32) inside
// heatnet_tpu/models/layers.py: Int8Conv (:859-866, dense convs of conv())
// and GroupedConvDense's int8 arm (:531-540, the block-diagonal dense form of
// the grouped 3x3). One kernel pair serves every int8 layer of ResNeXtSeg:
// 1x1 at stride 1 and 2, 3x3, 3x3 dilated (ASPP's rates 12/24/36), the
// grouped 3x3 (64 groups, 2/4/8/16 channels per group) and any other size,
// padded alike in height and width or (a frame split by rows, the shard
// extended by its halo rows) in width only.
//
// The function, exactly (the plain version is ops/int8_conv.py):
//   x_q  = clip(rint(x / max(x_scale, 1e-12)), -127, 127)   (IEEE division)
//   acc  = sum over taps and input channels of x_q * w_q    (int32, exact)
//   y    = T(T(acc) * T(max(x_scale, 1e-12) * w_scale[co]))  (T = bf16,
//          rounding after every operation as PyTorch's do)
//   y    = T(y + T(bias[co]))                                (if bias)
//   y    = T(act(float(y) * ep_scale[co] + ep_bias[co]))     (if an epilogue)
// Multiplies and adds are __fmul_rn / __fadd_rn so that nvcc does not
// contract them into an FMA that PyTorch's elementwise kernels do not use.
//
// Layouts. A dense conv is one block; a grouped conv is C/64 blocks of 64
// input and 64 output channels whose weight is block-diagonal (zero between
// groups): the zeros add exactly 0 to an int32 sum, so this is the grouped
// conv, as JAX's block-diagonal expansion is.
//  - int8_conv_quantize writes x_q as (N, H, W, blocks * cin_pad) int8, each
//    block's channels zero-padded to cin_pad, a multiple of 32, into a
//    scratch tensor the wrapper allocates.
//  - The weight comes quantized and packed by ops/int8_conv.py::pack_weight
//    as (blocks, rows, taps * cin_pad) int8: K in (ky, kx, ci) order, each
//    tap's channels zero-padded to cin_pad as x_q's are, rows (output
//    channels) zero-padded to a multiple of 64.
//
// What bounds it on the H100 (int8 at 1979 TOPS, 3.35 TB/s): the mod5 1x1s,
// ASPP's dilated 3x3s and the decoder's 3x3s are operations-bound, the
// stem, the grouped convs and the narrow 1x1s bytes-bound (chip_smoke.py 9a
// prints each shape's bound). The design:
//  - Quantize once per call (int8_conv_quantize), 2 bytes read and 1 written
//    per element, each element once, not once per output-channel tile, and
//    the product reads int8. The IEEE division's result comes from a
//    multiply by the reciprocal, the division itself only where the two
//    could round apart (quant1): a zero never reaches it (a zero numerator
//    leaves __fdiv_rn's fast path, which made a kernel that divided every
//    value 1.7x slower on post-ReLU inputs than on signed ones).
//  - int8_conv_gemm: a BM-pixel x BN-channel output tile per block, BN 64
//    (grouped blocks, the 13- and 1-channel heads), 128 or 256 (dense layers)
//    chosen from cout, BM 256 beside BN 128 and 128 otherwise; three
//    warpgroups: one producer, two consumers of BM / 2 rows each running
//    wgmma.m64nBNk32.s32.s8.s8 with both operands K-major in 128-byte-swizzled
//    shared memory (4 wgmma per 64-row block per 128-byte K step).
//  - A 4-stage ring with full/empty mbarriers. The weight tile comes by TMA
//    (a 3-D map over (taps * cin_pad, rows, blocks)); so does the activation tile
//    of a 1x1 conv at stride 1 (a 2-D map over (cq, N*H*W)). Every other conv
//    gathers its activation tile with 16-byte cp.async, 8 producer threads
//    per pixel row (a warp's copies are whole 128-byte lines), swizzled as
//    TMA would, out-of-image taps zero-filled (src-size 0), signalled with
//    cp.async.mbarrier.arrive.noinc.
//  - K steps are 128 bytes: one tap's channel chunk where cin_pad is a
//    multiple of 128, else (the stem's and grouped blocks' 64, the decoder's
//    288) a run across taps, so no step is half padding. A tap that reads
//    outside the image for every output pixel of the tile is skipped (exact:
//    it would add int32 zeros); across taps only whole kernel rows are. At
//    ASPP's rate 36 on 40x120 this drops ky = 0 or 2 for most tiles.
//  - The epilogue stages the int32 tile in shared memory, then dequantizes
//    8 channels per thread, their per-column values loaded once per tile and
//    kept in registers over the thread's rows, keeps the rounding chain
//    above (two values per bf16 conversion instruction) and writes 16-byte
//    stores, consecutive threads on consecutive addresses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;        // K bytes per ring stage (the swizzle span)
constexpr int kStages = 4;
constexpr int kThreads = 384;   // warpgroup 0 produces, 1 and 2 consume
constexpr int kProducers = 128;
constexpr int kChanAlign = 32;  // x_q's channel padding
constexpr int kRowAlign = 64;   // pack_weight's output-channel padding
constexpr int kMaxDevices = 16;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kElu = 3 };

struct Params {
  const int8_t* xq;       // (N, H, W, cq) int8 from int8_conv_quantize
  const float* w_scale;   // (Cout,)
  const float* x_scale;   // () on the device
  const float* bias;      // (Cout,) or null
  const float* ep_scale;  // (Cout,) or null: act(y * ep_scale + ep_bias)
  const float* ep_bias;
  __nv_bfloat16* out;     // (N, Ho, Wo, Cout)
  int h, w, cq, ho, wo, cout;
  int kh, kw, stride, pad_h, pad_w, dil;
  int cin_pad, chunks, cout_g, m;
  int flat;               // K steps run over (ky, kx, ci) across taps
  int tma_a;              // the activation tile comes by TMA (1x1, stride 1)
  int act;
  float slope;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two values rounded to bf16 (nearest even) at once: one cvt.rn.bf16x2.f32
// for both, the epilogue's conversions being its costliest instructions.
__device__ __forceinline__ __nv_bfloat162 round2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
  return h;
}

__device__ __forceinline__ float activate(float y, int act, float slope) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kLeaky) return y > 0.f ? y : __fmul_rn(y, slope);
  if (act == kElu) return y > 0.f ? y : expm1f(y);
  return y;
}

// x_q of one value, as a byte: clip(rint(__fdiv_rn(v, xs)), -127, 127)
// exactly, mostly without the division. With q = v / xs, t = v * inv (inv =
// RN(1 / xs)) is within 2^-23 |q| of q, and RN(q) within 2^-24 |q|, so the
// two round to the same integer unless t lies within |t| 2^-20 of a
// half-integer (the margin is 5x the error); only then (a share of about
// |t| 2^-19 < 3e-4 of the values, never a zero) the division decides.
// Beyond +-127 both clip to +-127. rint is the add of 1.5 * 2^23, whose low
// byte is the two's complement of the integer: no conversion instruction
// (a quarter of the ALU rate) per value.
__device__ __forceinline__ uint32_t quant1(float v, float xs, float inv) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  const float y = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  const float r = __fadd_rn(y, kRound);
  const float off = fabsf(__fsub_rn(y, __fsub_rn(r, kRound)));
  if (!(__fsub_rn(0.5f, off) > fabsf(y) * 9.5367432e-7f)) {  // 2^-20
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.f), 127.f);
    return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
  }
  return __float_as_uint(r) & 0xffu;
}

// VEC: cq == cin (every block's channels a multiple of 32), cin % 8 == 0:
// 8 channels per thread, a 16-byte load and an 8-byte store. Otherwise each
// thread writes 8 padded channels, reading the valid ones one at a time.
template <bool VEC>
__global__ void __launch_bounds__(256)
int8_conv_quantize(const __nv_bfloat16* __restrict__ x, const float* __restrict__ x_scale,
                   int8_t* __restrict__ xq, long long groups8, int cin, int cin_g,
                   int cin_pad, int cq) {
  const float xs = fmaxf(*x_scale, 1e-12f);
  const float inv = __frcp_rn(xs);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       g < groups8; g += stride) {
    uint32_t lo = 0, hi = 0;
    if constexpr (VEC) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + g);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t a = quant1(__uint_as_float(u[i] << 16), xs, inv);
        const uint32_t b = quant1(__uint_as_float(u[i] & 0xffff0000u), xs, inv);
        const uint32_t pair = a | (b << 8);
        if (i < 2) lo |= pair << (16 * i); else hi |= pair << (16 * (i - 2));
      }
    } else {
      const int per_px = cq / 8;
      const long long px = g / per_px;
      const int c = static_cast<int>(g - px * per_px) * 8;
      const __nv_bfloat16* xp = x + px * cin;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int blk = (c + i) / cin_pad, ci = c + i - blk * cin_pad;
        const uint32_t q =
            ci < cin_g ? quant1(__bfloat162float(xp[blk * cin_g + ci]), xs, inv) : 0u;
        if (i < 4) lo |= q << (8 * i); else hi |= q << (8 * (i - 4));
      }
    }
    reinterpret_cast<uint2*>(xq)[g] = make_uint2(lo, hi);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map, uint32_t dst,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map, uint32_t dst,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, or 16 zero bytes where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void sts_v2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" :: "r"(addr), "r"(a), "r"(b) : "memory");
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

// a K-major operand in 128-byte-swizzled rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d += A B^T in int32: wgmma.m64nNk32.s32.s8.s8, A (64 x 32) and B (N x 32)
// both K-major in shared memory (descriptors a, b). Thread t of the
// warpgroup holds, for each 8-column block j, d[4 j .. 4 j + 3] = D at (r, c),
// (r, c + 1), (r + 8, c), (r + 8, c + 1) with r = 16 (t / 32) + (t % 32) / 4
// and c = 8 j + 2 (t % 4).
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 64) wgmma_n64(d, a, b);
  else if constexpr (BN == 128) wgmma_n128(d, a, b);
  else wgmma_n256(d, a, b);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence, commit and wait
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Two neighbouring outputs (.x at the lower address) from their int32 sums
// and their columns' T(x_scale * w_scale), T(bias), ep_scale and ep_bias:
// the rounding chain above, as packed bf16.
__device__ __forceinline__ uint32_t epilogue_pair(int a0, int a1, float2 scale, float2 bias,
                                                  float2 eps, float2 epb, const Params& p) {
  float y0 = __int2float_rn(a0), y1 = __int2float_rn(a1);
  round2(y0, y1);
  y0 = __fmul_rn(y0, scale.x);
  y1 = __fmul_rn(y1, scale.y);
  __nv_bfloat162 h = round2(y0, y1);
  if (p.bias != nullptr) {
    y0 = __fadd_rn(y0, bias.x);
    y1 = __fadd_rn(y1, bias.y);
    h = round2(y0, y1);
  }
  if (p.ep_scale != nullptr) {
    y0 = activate(__fadd_rn(__fmul_rn(y0, eps.x), epb.x), p.act, p.slope);
    y1 = activate(__fadd_rn(__fmul_rn(y1, eps.y), epb.y), p.act, p.slope);
    h = __floats2bfloat162_rn(y0, y1);
  }
  return *reinterpret_cast<uint32_t*>(&h);
}

// The taps (ky0 .. ky0+nky-1, kx0 .. kx0+nkx-1) that read inside the image for
// some output pixel of the tile m0 .. m0+bm-1: a tile within one output row
// bounds ox, within one image oy, and a tile across images reads every row.
// (ops/int8_conv.py::tile_taps is the same function.)
struct Taps {
  int ky0, nky, kx0, nkx;
};

__device__ __forceinline__ void tap_range(int lo, int hi, int s, int pad, int d, int k,
                                          int size, int& t0, int& nt) {
  int first = k, last = -1;
  for (int t = 0; t < k; ++t) {
    if (hi * s - pad + t * d >= 0 && lo * s - pad + t * d <= size - 1) {
      first = min(first, t);
      last = t;
    }
  }
  t0 = first;
  nt = max(0, last - first + 1);
}

__device__ __forceinline__ Taps tile_taps(const Params& p, int m0, int bm) {
  const int hw = p.ho * p.wo;
  const int last = min(m0 + bm, p.m) - 1;
  const int i0 = m0 / hw, i1 = last / hw;
  int oy_lo = 0, oy_hi = p.ho - 1, ox_lo = 0, ox_hi = p.wo - 1;
  if (i0 == i1) {
    const int r0 = m0 - i0 * hw, r1 = last - i1 * hw;
    oy_lo = r0 / p.wo;
    oy_hi = r1 / p.wo;
    if (oy_lo == oy_hi) {
      ox_lo = r0 - oy_lo * p.wo;
      ox_hi = r1 - oy_hi * p.wo;
    }
  }
  Taps t;
  tap_range(oy_lo, oy_hi, p.stride, p.pad_h, p.dil, p.kh, p.h, t.ky0, t.nky);
  tap_range(ox_lo, ox_hi, p.stride, p.pad_w, p.dil, p.kw, p.w, t.kx0, t.nkx);
  return t;
}

__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * kBK; }
// the epilogue's int32 tile, rows padded by 16 bytes
__host__ __device__ constexpr int stage_row_bytes(int bn) { return bn * 4 + 16; }
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  return kStages * stage_bytes(bm, bn) + 16 * bn + 2 * kStages * 8 + 1024;
}

// Grid: (M tiles, blocks * N tiles). A BM x BN tile, each consumer warpgroup
// BM / 2 rows as BM / 128 wgmma row blocks of 64. Shared memory
// (1024-aligned): kStages A tiles (BM rows x 128 bytes), kStages B tiles (BN
// rows x 128 bytes), the per-column epilogue values, the full and empty
// mbarriers. The epilogue stages its int32 tile over the A and B tiles once
// the ring is drained.
template <int BN, int BM>
__global__ void __launch_bounds__(kThreads, smem_bytes(BM, BN) <= 113 * 1024 ? 2 : 1)
int8_conv_gemm(const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap a_map, const Params p) {
  constexpr int kSub = BM / 128;  // wgmma row blocks per consumer warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a_tiles = smem_u32(smem);
  const uint32_t b_tiles = a_tiles + kStages * BM * kBK;
  // per output channel of the tile: T(x_scale * w_scale), T(bias), ep_scale,
  // ep_bias, BN floats each
  const uint32_t col_params = a_tiles + kStages * stage_bytes(BM, BN);
  const uint32_t full = col_params + 16 * BN;
  const uint32_t empty = full + kStages * 8;

  const int tid = threadIdx.x;
  const int tiles_n = (p.cout_g + BN - 1) / BN;
  const int blk = blockIdx.y / tiles_n;
  const int n0 = (blockIdx.y - blk * tiles_n) * BN;
  const int m0 = blockIdx.x * BM;
  const Taps taps = tile_taps(p, m0, BM);
  // Where a tap's channels are a multiple of the K step, a step is one tap's
  // chunk and every tap taps skips is skipped. Otherwise (cin_pad 64 or 288)
  // the steps run over K = (ky, kx, ci) across taps, so no step is half
  // padding, and only whole kernel rows (ky) are skipped.
  const int k_row = p.kw * p.cin_pad;
  const int k_begin = taps.ky0 * k_row, k_end = (taps.ky0 + taps.nky) * k_row;
  const int nsteps = p.flat ? (k_end - k_begin + kBK - 1) / kBK
                            : taps.nky * taps.nkx * p.chunks;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, p.tma_a ? 1 : kProducers + 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProducers) {
    // producer. The gather: 8 threads per tile row, each one 16-byte chunk
    // per K step, so that a warp's copies cover whole 128-byte lines of 4
    // rows; a thread's BM / 16 rows (first pixel of the image, iy0, ix0) are
    // found once per tile.
    if (p.tma_a && tid != 0) return;
    constexpr int kRows = BM / (kProducers / 8);
    const int piece = tid & 7;
    int row_px[kRows], row_y[kRows], row_x[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int m = m0 + (tid >> 3) + j * (kProducers / 8);
      int img = 0, oy = 0, ox = 0;
      if (m < p.m) {
        img = m / (p.ho * p.wo);
        const int rem = m - img * p.ho * p.wo;
        oy = rem / p.wo;
        ox = rem - oy * p.wo;
      }
      row_px[j] = img * p.h * p.w;
      row_y[j] = m < p.m ? oy * p.stride - p.pad_h : INT_MIN / 2;  // never inside
      row_x[j] = ox * p.stride - p.pad_w;
    }
    const int8_t* xb = p.xq + blk * p.cin_pad;
    const uint32_t b_bytes = BN * kBK;
    for (int i = 0; i < nsteps; ++i) {
      const int s = i % kStages;
      // the step's K start in the weight, and this thread's piece's tap and
      // channel (valid when k < k_end)
      int k0, ky, kx, ci;
      if (p.flat) {
        k0 = k_begin + i * kBK;
        const int k = k0 + 16 * piece;
        const int tap = k / p.cin_pad;
        ci = k - tap * p.cin_pad;
        ky = tap / p.kw;
        kx = tap - ky * p.kw;
      } else {
        const int chunk = i % p.chunks, t = i / p.chunks;
        ky = taps.ky0 + t / taps.nkx;
        kx = taps.kx0 + t % taps.nkx;
        ci = chunk * kBK + 16 * piece;
        k0 = (ky * p.kw + kx) * p.cin_pad + chunk * kBK;
      }
      mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t a_dst = a_tiles + s * BM * kBK;
      if (tid == 0) {
        mbar_expect_tx(full + 8 * s, b_bytes + (p.tma_a ? BM * kBK : 0));
        tma_load_3d(&w_map, b_tiles + s * BN * kBK, full + 8 * s, k0, n0, blk);
        if (p.tma_a) tma_load_2d(&a_map, a_dst, full + 8 * s, k0, m0);
      }
      if (!p.tma_a) {
        // a piece past the tap's channels (per-tap steps) keeps stale bytes,
        // which meet the weight's zero padding; one past k_end (across taps)
        // meets the next kernel row's weights, so it is zero-filled
        const bool live = p.flat ? k0 + 16 * piece < k_end : ci < p.cin_pad;
        if (live || p.flat) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int r = (tid >> 3) + j * (kProducers / 8);
            const int iy = row_y[j] + ky * p.dil, ix = row_x[j] + kx * p.dil;
            const bool ok = live && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
            const int8_t* src =
                ok ? xb + static_cast<size_t>(row_px[j] + iy * p.w + ix) * p.cq + ci : p.xq;
            cp_async16(a_dst + r * kBK + ((piece ^ (r & 7)) << 4), src, ok ? 16 : 0);
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(full + 8 * s) : "memory");
      }
    }
    return;
  }

  // consumers: warpgroup cw multiplies rows cw BM / 2 .. (cw + 1) BM / 2 - 1
  const int ctid = tid - kProducers;
  const int cw = ctid >> 7;
  const float xs = fmaxf(*p.x_scale, 1e-12f);
  for (int j = ctid; j < BN; j += 2 * 128) {
    const int col = n0 + j;
    const bool ok = col < p.cout_g;
    const int co = blk * p.cout_g + col;
    sts_f32(col_params + 4 * j, ok ? round_bf16(__fmul_rn(xs, p.w_scale[co])) : 0.f);
    sts_f32(col_params + 4 * (BN + j),
            ok && p.bias != nullptr ? round_bf16(p.bias[co]) : 0.f);
    sts_f32(col_params + 4 * (2 * BN + j),
            ok && p.ep_scale != nullptr ? p.ep_scale[co] : 0.f);
    sts_f32(col_params + 4 * (3 * BN + j),
            ok && p.ep_scale != nullptr ? p.ep_bias[co] : 0.f);
  }

  int acc[kSub][BN / 2];
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[u][i] = 0;
    fence_regs<BN / 2>(acc[u]);
  }
  for (int i = 0; i < nsteps; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    // cp.async wrote the A tile through the generic proxy; wgmma reads
    // through the async proxy
    if (!p.tma_a) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint64_t db = smem_desc(b_tiles + s * BN * kBK);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const uint64_t da = smem_desc(a_tiles + s * BM * kBK + (cw * kSub + u) * 64 * kBK);
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) wgmma<BN>(acc[u], da + 2 * kk, db + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < kSub; ++u) fence_regs<BN / 2>(acc[u]);
    // the previous step's wgmma are done: its stage may refill
    if (i > 0 && (ctid & 127) == 0) mbar_arrive(empty + 8 * ((i - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int u = 0; u < kSub; ++u) fence_regs<BN / 2>(acc[u]);

  // epilogue: both consumer warpgroups are past their last wgmma, so the ring
  // is free for the int32 tile. The fragments go to shared memory as they
  // are; then each thread dequantizes 8 consecutive channels of a row (or,
  // where rows are not 16-byte aligned, one channel) and writes them with
  // consecutive threads on consecutive addresses. Kept out of the unrolled
  // fragment loop, the rounding chain is compiled a few times, not once per
  // accumulator register (which overflowed the instruction cache).
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  constexpr int kRow = stage_row_bytes(BN);
  const uint32_t stage = a_tiles;
  {
    const int lane = ctid & 31, warp = (ctid >> 5) & 3;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const int frag_row = (cw * kSub + u) * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int k = 0; k < BN / 8; ++k) {
        const uint32_t at = stage + frag_row * kRow + 4 * (8 * k + 2 * (lane & 3));
        sts_v2(at, acc[u][4 * k], acc[u][4 * k + 1]);
        sts_v2(at + 8 * kRow, acc[u][4 * k + 2], acc[u][4 * k + 3]);
      }
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int rows = min(BM, p.m - m0), cols = min(BN, p.cout_g - n0);
  __nv_bfloat16* out = p.out + static_cast<size_t>(m0) * p.cout + blk * p.cout_g + n0;
  if (p.cout % 8 == 0 && cols == BN) {
    // a thread keeps 8 columns (their values in registers) over every
    // (256 / (BN / 8))-th row; a warp writes whole 16-byte chunks of rows
    constexpr int kChunks = BN / 8, kRowStep = 256 / kChunks;
    const int c = (ctid % kChunks) * 8;
    float prm[4][8] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((i == 1 && p.bias == nullptr) || (i >= 2 && p.ep_scale == nullptr)) continue;
      const uint4 v0 = lds_v4(col_params + 4 * (i * BN + c));
      const uint4 v1 = lds_v4(col_params + 4 * (i * BN + c) + 16);
      const uint32_t u[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) prm[i][e] = __uint_as_float(u[e]);
    }
    for (int r = ctid / kChunks; r < rows; r += kRowStep) {
      const uint4 lo = lds_v4(stage + r * kRow + 4 * c);
      const uint4 hi = lds_v4(stage + r * kRow + 4 * c + 16);
      const int a[8] = {static_cast<int>(lo.x), static_cast<int>(lo.y),
                        static_cast<int>(lo.z), static_cast<int>(lo.w),
                        static_cast<int>(hi.x), static_cast<int>(hi.y),
                        static_cast<int>(hi.z), static_cast<int>(hi.w)};
      uint32_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        b[e] = epilogue_pair(a[2 * e], a[2 * e + 1],
                             make_float2(prm[0][2 * e], prm[0][2 * e + 1]),
                             make_float2(prm[1][2 * e], prm[1][2 * e + 1]),
                             make_float2(prm[2][2 * e], prm[2][2 * e + 1]),
                             make_float2(prm[3][2 * e], prm[3][2 * e + 1]), p);
      }
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * p.cout + c) =
          make_uint4(b[0], b[1], b[2], b[3]);
    }
  } else {
    // rows not 16-byte aligned (cout 269, 13, 1) or a ragged last N tile:
    // one channel per thread, consecutive threads on consecutive channels
    for (int q = ctid; q < rows * BN; q += 256) {
      const int r = q / BN, c = q - r * BN;
      if (c < cols) {
        uint32_t a;
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(a) : "r"(stage + r * kRow + 4 * c)
                     : "memory");
        const float sc = lds_f32(col_params + 4 * c), bi = lds_f32(col_params + 4 * (BN + c));
        const float es = lds_f32(col_params + 4 * (2 * BN + c));
        const float eb = lds_f32(col_params + 4 * (3 * BN + c));
        const uint32_t bits = epilogue_pair(static_cast<int>(a), 0, make_float2(sc, sc),
                                            make_float2(bi, bi), make_float2(es, es),
                                            make_float2(eb, eb), p);
        out[static_cast<size_t>(r) * p.cout + c] =
            __ushort_as_bfloat16(static_cast<unsigned short>(bits & 0xffffu));
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the runtime hands out its
// address, so the library needs no link against libcuda (as in
// grouped_conv3x3.cu).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// An int8 map of `rank` dims (innermost first, strides in bytes of dims
// 1..rank-1), box (128, box1, 1), 128-byte swizzle; out-of-bounds reads zero.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, int box1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box1),
                             1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int BM>
cudaError_t launch_gemm(const CUtensorMap& w_map, const CUtensorMap& a_map,
                        const Params& p, int blocks, cudaStream_t stream) {
  auto kern = int8_conv_gemm<BN, BM>;
  static bool limit_set[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!limit_set[device]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(BM, BN));
    if (e != cudaSuccess) return e;
    limit_set[device] = true;
  }
  const dim3 grid((p.m + BM - 1) / BM, blocks * ((p.cout_g + BN - 1) / BN));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kern<<<grid, kThreads, smem_bytes(BM, BN), stream>>>(w_map, a_map, p);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) bf16, zero-padded by pad_h rows and pad_w columns a side
// (pad_h 0 for a shard already extended by its halo rows, parallel/spatial.py);
// xq: scratch of N*H*W*cq int8, cq = (Cin / cin_g) *
// cin_pad, cin_pad = cin_g rounded up to 32; w: pack_weight's (blocks, rows,
// kh*kw*cin_pad) int8, rows = cout_g rounded up to
// 64; w_scale (Cout,), x_scale () f32 on the device; bias, ep_scale and ep_bias
// (Cout,) f32 or null (ep_scale and ep_bias together); out: (N, Ho, Wo, Cout)
// bf16. act: 0 none, 1 relu, 2 leaky_relu(slope), 3 elu. Launches
// int8_conv_quantize, then int8_conv_gemm. Returns the first launch error,
// else cudaGetLastError(); the caller raises if it is not 0.
int hn_int8_conv(const void* x, void* xq, const void* w, const void* w_scale,
                 const void* x_scale, const void* bias, const void* ep_scale,
                 const void* ep_bias, void* out, int n, int h, int wd, int cin, int ho,
                 int wo, int cout, int kh, int kw, int stride, int pad_h, int pad_w, int dil,
                 int cin_g, int cout_g, int rows, int k_total, int act, float slope,
                 void* stream) {
  const long long m = static_cast<long long>(n) * ho * wo;
  const int cin_pad = (cin_g + kChanAlign - 1) / kChanAlign * kChanAlign;
  const int blocks = cin_g > 0 ? cin / cin_g : 0;
  const long long cq = static_cast<long long>(blocks) * cin_pad;
  if (n < 1 || h < 1 || wd < 1 || ho < 1 || wo < 1 || cin_g < 1 || cout_g < 1 ||
      pad_h < 0 || pad_w < 0 ||
      cin % cin_g != 0 || cout % cout_g != 0 || blocks != cout / cout_g ||
      rows % kRowAlign != 0 || rows < cout_g || k_total != kh * kw * cin_pad ||
      m > (1ll << 31) - 1 || static_cast<long long>(n) * h * wd > (1ll << 31) - 1 ||
      static_cast<long long>(n) * h * wd * cq > (1ll << 40) ||
      (ep_scale == nullptr) != (ep_bias == nullptr) || act < kNone || act > kElu ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xq) |
       reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(out)) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // cuTensorMapEncodeTiled is a driver call and needs a current context.
  static thread_local int bound_device = -1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && device != bound_device) {
    e = cudaSetDevice(device);
    if (e == cudaSuccess) bound_device = device;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  // pass 1: x_q, once per call
  const long long pixels = static_cast<long long>(n) * h * wd;
  const bool vec = cq == cin && cin % 8 == 0;
  const long long groups8 = pixels * cq / 8;
  const long long want = (groups8 + 255) / 256;
  const int qblocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  if (vec) {
    int8_conv_quantize<true><<<qblocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(x_scale),
        static_cast<int8_t*>(xq), groups8, cin, cin_g, cin_pad, static_cast<int>(cq));
  } else {
    int8_conv_quantize<false><<<qblocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(x_scale),
        static_cast<int8_t*>(xq), groups8, cin, cin_g, cin_pad, static_cast<int>(cq));
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // pass 2: the product. BN: 64 for the grouped blocks and narrow heads, 256
  // where it divides cout, else 128. BM: 256 beside BN 128, which halves the
  // weight tiles read per output; 128 beside BN 256 (the accumulators of
  // 128 x 256 fill the registers) and BN 64 (two blocks per SM measured
  // faster there, tools/int8_conv_variants.py).
  const int bn = cout_g >= 256 && cout_g % 256 == 0 ? 256 : cout_g >= 128 ? 128 : 64;
  const int bm = bn == 128 ? 256 : 128;
  Params p;
  p.xq = static_cast<const int8_t*>(xq);
  p.w_scale = static_cast<const float*>(w_scale);
  p.x_scale = static_cast<const float*>(x_scale);
  p.bias = static_cast<const float*>(bias);
  p.ep_scale = static_cast<const float*>(ep_scale);
  p.ep_bias = static_cast<const float*>(ep_bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = h; p.w = wd; p.cq = static_cast<int>(cq); p.ho = ho; p.wo = wo; p.cout = cout;
  p.kh = kh; p.kw = kw; p.stride = stride; p.pad_h = pad_h; p.pad_w = pad_w; p.dil = dil;
  p.cin_pad = cin_pad; p.chunks = (cin_pad + kBK - 1) / kBK; p.cout_g = cout_g;
  p.flat = cin_pad % kBK != 0;
  p.m = static_cast<int>(m);
  p.tma_a = kh == 1 && kw == 1 && stride == 1 && pad_h == 0 && pad_w == 0 && blocks == 1 &&
            cin_pad >= kBK && m >= bm;
  p.act = act; p.slope = slope;
  CUtensorMap w_map, a_map = {};
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(k_total),
                                static_cast<cuuint64_t>(rows),
                                static_cast<cuuint64_t>(blocks)};
  const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(k_total),
                                   static_cast<cuuint64_t>(k_total) * rows};
  if (!make_map(&w_map, w, 3, w_dims, w_strides, bn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.tma_a) {
    const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(cq), static_cast<cuuint64_t>(m)};
    const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(cq)};
    if (!make_map(&a_map, xq, 2, a_dims, a_strides, bm)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  e = bn == 256 ? launch_gemm<256, 128>(w_map, a_map, p, blocks, s)
      : bn == 128 ? launch_gemm<128, 256>(w_map, a_map, p, blocks, s)
                  : launch_gemm<64, 128>(w_map, a_map, p, blocks, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
