// Static-prefix sprite suffix of the 64x64 frame render, for sm_90a.
//
// Replaces the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py
// (_render_env inside the pl.pallas_call at :1136) on its static-prefix
// path, which maze and plunder take: start from the cached per-level frame
// (K1a), paint every slot in order into premultiplied RGBA canvases, one
// per z level of each sprite pool, rounding each canvas to bf16 after every
// slot (K1b), then composite the canvases over the frame and write uint8
// (K1c).  procgen_tpu/render/render_kernel.py:render_suffix_reference is
// the same function in plain torch; the two agree byte for byte.  The slot
// code is shared with render_frame.cu (sprite.cuh).
//
// Two instances, picked once a launch by the C entry point:
// render_suffix_kernel<false> (maze) paints the entity pool's cap slots and
// composites its canvases in index order; render_suffix_kernel<true>
// (plunder) also stages the decor pool's slots, walks each pool to its live
// count, and composites at z = 0, then z = 1, the entity pool's canvas and
// then the decor pool's (pallas_kernel.py:936-967).  The decor pool's
// tests stay out of the entity-only instance.
//
// Bound: bytes.  Per env and step the kernel reads the 12 KiB base frame
// and writes the 12 KiB frame; the slot parameters (72 bytes a slot) and
// the atlas texels it touches (at most 4 bytes a pixel per slot, from an
// atlas that stays in L2) are small beside that.  At 4096 envs a launch
// moves ~100 MB.  Design: one thread per output pixel, grid (N, 16) of
// 256-thread blocks, one env's four pixel rows per block; the block stages
// its env's slot parameters (both pools: (48 + 24) x 72 bytes for plunder)
// in shared memory; each thread keeps its canvases in registers, so
// nothing but the frame itself goes through device memory.  The TPU
// kernel's 32-row slabs are a TPU scheduling device and are left out:
// outside a sprite's rect its alpha is 0, and blending with alpha 0 is an
// exact identity.
//
// Exactness: build with -fmad=false -prec-div=true -ftz=false (kernels.py)
// and keep the TPU kernel's operation order (pallas_kernel.py:719-830).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sprite.cuh"

namespace {

using namespace pgt;

constexpr int MAX_NZ = 4;  // canvases of both pools together
constexpr int ROWS_PER_BLOCK = 4;
constexpr int THREADS = RES * ROWS_PER_BLOCK;

// The pools' shapes: slots, canvases, each pool's canvas index of z = 0
// and z = 1 (-1 for none; read by the decor instance).
struct Pools {
  int cap, dcap, nz, nzd;
  int zs[2], dzs[2];
  int S, n_rows;
};

template <bool DECOR>
__global__ void __launch_bounds__(THREADS)
render_suffix_kernel(const uint8_t* __restrict__ base,
                     const float* __restrict__ ent_f,
                     const int32_t* __restrict__ ent_i,
                     const float* __restrict__ dec_f,
                     const int32_t* __restrict__ dec_i,
                     const int32_t* __restrict__ counts,
                     const uint8_t* __restrict__ atlas,
                     uint8_t* __restrict__ out, Pools p) {
  extern __shared__ int32_t smem[];
  float* sf = reinterpret_cast<float*>(smem);              // [cap, EF_N]
  int32_t* si = smem + p.cap * EF_N;                       // [cap, EI_N]
  float* df = reinterpret_cast<float*>(si + p.cap * EI_N);  // [dcap, EF_N]
  int32_t* di = reinterpret_cast<int32_t*>(df + p.dcap * EF_N);  // [dcap, EI_N]

  const int64_t env = blockIdx.x;
  load_slots(ent_f, ent_i, env, p.cap, sf, si);
  if constexpr (DECOR) load_slots(dec_f, dec_i, env, p.dcap, df, di);
  __syncthreads();

  const int row = blockIdx.y * ROWS_PER_BLOCK + threadIdx.x / RES;
  const int col = threadIdx.x % RES;
  const float sx = (float)col + 0.5f, sy = (float)row + 0.5f;

  float canv[MAX_NZ][4];
  clear_canvases<MAX_NZ>(canv);
  const int64_t px = ((env * RES + row) * RES + col) * 3;
  if constexpr (DECOR) {
    const int n_ent = clampi(counts[env * 2], 0, p.cap);
    const int n_dec = clampi(counts[env * 2 + 1], 0, p.dcap);
    paint_slots<MAX_NZ>(sf, si, n_ent, p.nz, 0, atlas, p.S, p.n_rows, sx, sy,
                        canv);
    paint_slots<MAX_NZ>(df, di, n_dec, p.nzd, p.nz, atlas, p.S, p.n_rows, sx,
                        sy, canv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float o = (float)base[px + c];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        o = composite<MAX_NZ>(o, canv, p.zs[k], c);
        o = composite<MAX_NZ>(o, canv, p.dzs[k] < 0 ? -1 : p.nz + p.dzs[k], c);
      }
      out[px + c] = (uint8_t)(int32_t)o;
    }
  } else {
    paint_slots<MAX_NZ>(sf, si, p.cap, p.nz, 0, atlas, p.S, p.n_rows, sx, sy,
                        canv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float o = (float)base[px + c];
#pragma unroll
      for (int z = 0; z < MAX_NZ; ++z) {
        if (z < p.nz) o = rintf(canv[z][c] + o * (1.f - canv[z][3]));
      }
      out[px + c] = (uint8_t)(int32_t)o;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes by procgen_tpu_torch/kernels.py).
// base/out: uint8 [n, 64, 64, 3]; ent_f / dec_f: f32 [n, cap|dcap, 8];
// ent_i / dec_i: int32 [n, cap|dcap, 10]; counts: int32 [n, 2], the live
// counts of the entity and decor pools; atlas: uint8 [n_rows, S, S, 4].
// dcap == 0 launches the entity-only instance, which reads no decor
// pointer and no count; otherwise z0/z1 and dz0/dz1 are each pool's canvas
// index of z = 0 and z = 1 among its nz / nzd canvases, or -1 for none.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int render_suffix(const uint8_t* base, const float* ent_f,
                             const int32_t* ent_i, const float* dec_f,
                             const int32_t* dec_i, const int32_t* counts,
                             const uint8_t* atlas, uint8_t* out, int n,
                             int cap, int dcap, int nz, int nzd, int z0,
                             int z1, int dz0, int dz1, int S, int n_rows,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool decor = dcap > 0;
  bool ok = nz >= 1 && cap >= 0 && dcap >= 0 && S >= 1 && n_rows >= 1 &&
            nz + (decor ? nzd : 0) <= MAX_NZ;
  if (decor)
    ok = ok && nzd >= 1 && z0 >= -1 && z0 < nz && z1 >= -1 && z1 < nz &&
         dz0 >= -1 && dz0 < nzd && dz1 >= -1 && dz1 < nzd;
  const size_t smem = (size_t)(cap + dcap) * (EF_N + EI_N) * sizeof(int32_t);
  if (!ok || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const Pools p{cap, dcap, nz, decor ? nzd : 0, {z0, z1}, {dz0, dz1}, S, n_rows};
  const dim3 grid((unsigned)n, RES / ROWS_PER_BLOCK);
  auto kernel = decor ? render_suffix_kernel<true> : render_suffix_kernel<false>;
  kernel<<<grid, THREADS, smem, stream>>>(base, ent_f, ent_i, dec_f, dec_i,
                                          counts, atlas, out, p);
  return (int)cudaGetLastError();
}
