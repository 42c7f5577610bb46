// Static-prefix sprite suffix of the 64x64 frame render, for sm_90a.
//
// Replaces the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py
// (_render_env inside the pl.pallas_call at :1136) on its static-prefix
// path, which maze takes: start from the cached per-level frame (K1a),
// paint every entity slot in order into premultiplied RGBA canvases, one
// per z level, rounding each canvas to bf16 after every slot (K1b), then
// composite the canvases over the frame in z order and write uint8 (K1c).
// procgen_tpu_torch/render/render_kernel.py:render_suffix_reference is the
// same function in plain torch; the two agree byte for byte.
//
// Bound: bytes.  Per env and step the kernel reads the 12 KiB base frame
// and writes the 12 KiB frame; the slot parameters (72 bytes a slot) and
// the atlas texels it touches (at most 4 bytes a pixel per slot, from a
// 80 KiB atlas that stays in L2) are small beside that.  At 4096 envs a
// launch moves ~100 MB.  Design: one thread per output pixel, grid
// (N, 16) of 256-thread blocks, one env's four pixel rows per block; the
// block stages its env's slot parameters in shared memory; each thread
// keeps its canvases in registers, so nothing but the frame itself goes
// through device memory.  The TPU kernel's 32-row slabs are a TPU
// scheduling device and are left out: outside a sprite's rect its alpha
// is 0, and blending with alpha 0 is an exact identity.
//
// Exactness: build with -fmad=false -prec-div=true -ftz=false (kernels.py)
// and keep the TPU kernel's operation order (pallas_kernel.py:719-830):
// a = ((texel * f32(1/255)) * alpha) * cover; c = bf16(rgb*a + c*(1-a)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RES = 64;
constexpr int ROWS_PER_BLOCK = 4;
constexpr int THREADS = RES * ROWS_PER_BLOCK;
constexpr int MAX_NZ = 4;

// ent_f / ent_i columns (render_kernel.py)
constexpr int EF_X0 = 0, EF_Y0 = 1, EF_W2 = 2, EF_H2 = 3, EF_ALPHA = 4,
              EF_R = 5, EF_N = 8;
constexpr int EI_ROW = 0, EI_LIVE = 1, EI_FB = 2, EI_PFLIP = 3, EI_QFLIP = 4,
              EI_Z = 5, EI_NTH = 6, EI_NTV = 7, EI_TILEH = 8, EI_TILEV = 9,
              EI_N = 10;

// the f32 rounding of the double 1/255, as the JAX code multiplies by it
constexpr float INV255 = 0x1.010102p-8f;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// texel index along one axis: (pix - origin) / extent, optional in-rect
// tiling, nearest texel, optional flip
__device__ __forceinline__ int axis_index(float pix, float origin,
                                          float extent, int ntiles, int tile,
                                          int flip, int S, bool* valid) {
  float u = (pix - origin) / extent;
  *valid = (u >= 0.f) && (u < 1.f);
  float ut = u * (float)ntiles;
  float uu = tile > 0 ? ut - floorf(ut) : u;
  int ui = clampi((int)(uu * (float)S), 0, S - 1);
  return flip > 0 ? S - 1 - ui : ui;
}

__global__ void __launch_bounds__(THREADS)
render_suffix_kernel(const uint8_t* __restrict__ base,
                     const float* __restrict__ ent_f,
                     const int32_t* __restrict__ ent_i,
                     const uint8_t* __restrict__ atlas,
                     uint8_t* __restrict__ out, int cap, int nz, int S,
                     int n_rows) {
  extern __shared__ int32_t smem[];
  float* sf = reinterpret_cast<float*>(smem);  // [cap, EF_N]
  int32_t* si = smem + cap * EF_N;             // [cap, EI_N]

  const int64_t env = blockIdx.x;
  for (int k = threadIdx.x; k < cap * EF_N; k += THREADS)
    sf[k] = ent_f[env * cap * EF_N + k];
  for (int k = threadIdx.x; k < cap * EI_N; k += THREADS)
    si[k] = ent_i[env * cap * EI_N + k];
  __syncthreads();

  const int row = blockIdx.y * ROWS_PER_BLOCK + threadIdx.x / RES;
  const int col = threadIdx.x % RES;
  const float sy = (float)row + 0.5f;
  const float sx = (float)col + 0.5f;

  float canv[MAX_NZ][4];
#pragma unroll
  for (int z = 0; z < MAX_NZ; ++z)
#pragma unroll
    for (int c = 0; c < 4; ++c) canv[z][c] = 0.f;

  for (int i = 0; i < cap; ++i) {
    const float* f = sf + i * EF_N;
    const int32_t* e = si + i * EI_N;
    // a dead or foreign-z slot blends with a = 0: an exact identity
    if (!(e[EI_LIVE] > 0 && e[EI_Z] >= 0)) continue;
    const int zc = e[EI_Z] < nz - 1 ? e[EI_Z] : nz - 1;

    bool xvalid, yvalid;
    const int q = axis_index(sx, f[EF_X0], f[EF_W2], e[EI_NTH], e[EI_TILEH],
                             e[EI_QFLIP], S, &xvalid);
    const int p = axis_index(sy, f[EF_Y0], f[EF_H2], e[EI_NTV], e[EI_TILEV],
                             e[EI_PFLIP], S, &yvalid);
    const bool inside = xvalid && yvalid;
    const float cover = inside ? 1.f : 0.f;

    float tex[4] = {0.f, 0.f, 0.f, 0.f};
    if (inside) {
      const int r = clampi(e[EI_ROW], 0, n_rows - 1);
      const uint8_t* t = atlas + (((int64_t)r * S + p) * S + q) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) tex[c] = (float)t[c];
    }

    const bool fb = e[EI_FB] > 0;
    const float a = fb ? cover : ((tex[3] * INV255) * f[EF_ALPHA]) * cover;
    const float keep = 1.f - a;
#pragma unroll
    for (int z = 0; z < MAX_NZ; ++z) {
      if (z != zc) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float rgb = fb ? f[EF_R + c] : tex[c];
        canv[z][c] = bf16_round(rgb * a + canv[z][c] * keep);
      }
      canv[z][3] = bf16_round(a + canv[z][3] * keep);
    }
  }

  const int64_t px = ((env * RES + row) * RES + col) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float o = (float)base[px + c];
#pragma unroll
    for (int z = 0; z < MAX_NZ; ++z) {
      if (z < nz) o = rintf(canv[z][c] + o * (1.f - canv[z][3]));
    }
    out[px + c] = (uint8_t)(int32_t)o;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes by procgen_tpu_torch/kernels.py).
// base/out: uint8 [n, 64, 64, 3]; ent_f: f32 [n, cap, 8]; ent_i: int32
// [n, cap, 10]; atlas: uint8 [n_rows, S, S, 4].  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success).
extern "C" int render_suffix(const uint8_t* base, const float* ent_f,
                             const int32_t* ent_i, const uint8_t* atlas,
                             uint8_t* out, int n, int cap, int nz, int S,
                             int n_rows, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (nz < 1 || nz > MAX_NZ || cap < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n, RES / ROWS_PER_BLOCK);
  const size_t smem = (size_t)cap * (EF_N + EI_N) * sizeof(int32_t);
  render_suffix_kernel<<<grid, THREADS, smem, stream>>>(
      base, ent_f, ent_i, atlas, out, cap, nz, S, n_rows);
  return (int)cudaGetLastError();
}
