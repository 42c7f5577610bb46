// Sprite-slot painting shared by the frame kernels (render_suffix.cu,
// render_frame.cu): the K1b per-slot pass and the K1c canvas composite of
// the Pallas TPU kernel procgen_tpu/render/pallas_kernel.py (_render_env,
// slot_body :706-830 and apply_canvas :946-950).
//
// A pixel's canvases live in registers, one premultiplied RGBA canvas per z
// level of each sprite pool.  Every slot blends into the canvas of its z
// level with a = (texel * (alpha * f32(1/255))) * cover and the canvas is
// rounded to bf16 after every slot, in the Pallas kernel's operation order
// as XLA runs it on the CPU (it multiplies the slot's two scalar factors
// first).
// A slot that misses the pixel blends with a = 0 and a dead or foreign-z
// slot with a = 0 too: for finite slot values (alpha in [0, 1], colours
// 0-255, as prep writes them) that blend leaves a bf16-rounded canvas
// unchanged, so such slots are skipped.  Build with -fmad=false
// -prec-div=true -ftz=false.
//
// The skipping is planned once per env, by the whole block, in shared
// memory (SlotTables):
//   1. compact_slots: one warp lists the slots that paint at all (live,
//      z >= 0, under the pool's live count, into a canvas that is
//      composited, and with a pixel span on both axes, axis_span), the
//      entity pool's and then the decor pool's, in slot order, with what
//      their blend needs (SlotPaint);
//   2. axis_tables: the texel index of every listed slot for each of the 64
//      pixel columns (qx) and rows (py) inside its span, by the same
//      axis_index on the same floats as a per-pixel walk would compute them
//      (the x index depends only on the slot and the column, the y index
//      only on the slot and the row), as uint8 with 255 for outside the
//      rectangle; and for each row a bitmask of the listed slots whose
//      rectangle covers it (shared-memory atomicOr into masks that
//      clear_masks zeroed);
//   3. paint_pixel: a pixel walks the set bits of its row's mask in
//      ascending order (slot order) and blends the slots whose column
//      index is valid.  A warp is 32 columns of one row, so its walk is
//      uniform.
// The canvases are numbered by their place in the composite order
// (CanvasOrder), so the composites index them at compile time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace pgt {

constexpr int RES = 64;
constexpr int FRAME_BYTES = RES * RES * 3;
constexpr uint8_t OUTSIDE = 255;  // axis table entry: the rect misses
// shared memory a block may take on sm_90 (227 KiB)
constexpr size_t SMEM_MAX = 232448;

// ent_f / ent_i columns (procgen_tpu_torch/render/render_kernel.py)
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

// What a listed slot's blend needs (two 16-byte words).
struct __align__(16) SlotPaint {
  int texel0;  // the atlas row's first texel: clamp(row) * S * S
  int zc;      // its canvas's place in the composite order
  int fb;      // fallback colour instead of the texture
  int span;    // its pixel spans: x lo, x hi, y lo, y hi, a byte each
  float alpha;  // its alpha times f32(1/255)
  float rgb[3];
};

// The canvases in composite order: pos[c] is canvas c's place (-1: never
// composited, so its slots need not paint); places [0, end_pre) are
// composited before the grid (z = -1), [end_pre, end_all) after the
// colored cells (z = 0, then z = 1), or over the base frame.
constexpr int MAX_CANVASES = 4;
struct CanvasOrder {
  int pos[MAX_CANVASES];
  int end_pre, end_all;
  __host__ __device__ int of(int canvas) const {
    return canvas == 0 ? pos[0]
         : canvas == 1 ? pos[1]
         : canvas == 2 ? pos[2]
         : canvas == 3 ? pos[3]
                       : -1;
  }
};

// The order of the composites "canvas zs[k], then canvas nz + dzs[k]" for
// k = 0 .. levels - 1 (-1: none), the first pre_levels of them before the
// grid.  False if a canvas would be composited twice or is past the four.
inline bool make_order(const int* zs, const int* dzs, int levels,
                       int pre_levels, int nz, CanvasOrder* o) {
  for (int c = 0; c < MAX_CANVASES; ++c) o->pos[c] = -1;
  int m = 0;
  o->end_pre = 0;
  for (int k = 0; k < levels; ++k) {
    const int cs[2] = {zs[k], dzs[k] < 0 ? -1 : nz + dzs[k]};
    for (int c : cs) {
      if (c < 0) continue;
      if (c >= MAX_CANVASES || o->pos[c] >= 0) return false;
      o->pos[c] = m++;
    }
    if (k + 1 == pre_levels) o->end_pre = m;
  }
  o->end_all = m;
  return true;
}

// A span [lo, hi] of pixel indices that holds every pixel whose centre p
// passes axis_index's test 0 <= (p - origin) / extent < 1; all 64 pixels
// where the argument below needs more than 0 < extent < 2^20 and |origin|
// < 2^20.  There, u >= 0 needs p - origin >= 0 (a nonzero difference of
// floats rounds to its own sign), so i + 0.5 >= origin and i > floor(origin)
// - 1; u < 1 needs the rounded difference below extent, so p < origin +
// extent (1 + 2^-24), and the rounded origin + extent is off by at most
// 1/8, so i <= floor(origin + extent) + 1.  lo > hi: no pixel is inside.
__device__ __forceinline__ void axis_span(float origin, float extent, int* lo,
                                          int* hi) {
  if (extent > 0.f && extent < 1048576.f && fabsf(origin) < 1048576.f) {
    *lo = max((int)floorf(origin) - 1, 0);
    *hi = min((int)floorf(origin + extent) + 1, RES - 1);
  } else {
    *lo = 0;
    *hi = RES - 1;
  }
}

// Bump allocation of the dynamic shared memory, 16-byte aligned pieces;
// suffix_smem() and frame_smem() in render_kernel.py add up the same
// pieces.
struct Carve {
  unsigned char* p;
  template <class T>
  __device__ T* take(size_t n) {
    T* r = reinterpret_cast<T*>(p);
    p += (n * sizeof(T) + 15) & ~size_t(15);
    return r;
  }
};

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Words of a row's slot mask for ``total`` slots.
__host__ __device__ constexpr int mask_words(int total) {
  return (total + 31) / 32;
}

// Shared memory of the slot tables for pools of ``total`` slots together.
__host__ __device__ constexpr size_t slot_tables_bytes(int total) {
  return align16((size_t)total * sizeof(SlotPaint)) +
         align16((size_t)RES * mask_words(total) * 4) +
         align16((size_t)total * EF_N * 4) + align16((size_t)total * EI_N * 4) +
         align16((size_t)total * 4) + 2 * align16((size_t)total * RES) + 16;
}

// One env's slot tables in shared memory: the staged slots of both pools
// (entity slots [0, cap), decor slots [cap, cap + dcap)), the list of the
// slots that paint, and the per-axis and per-row tables of the listed ones.
struct SlotTables {
  SlotPaint* paint;  // [total], by list index
  uint32_t* mask;    // [RES][words]: listed slots covering each row
  float* sf;         // [total, EF_N]
  int32_t* si;       // [total, EI_N]
  int* list;         // [total]: the staged slot of each list index
  uint8_t* qx;       // [total][RES]: texel column per pixel column
  uint8_t* py;       // [total][RES]: texel row per pixel row
  int* n_listed;

  __device__ void carve(Carve& cv, int total) {
    paint = cv.take<SlotPaint>(total);
    mask = cv.take<uint32_t>((size_t)RES * mask_words(total));
    sf = cv.take<float>((size_t)total * EF_N);
    si = cv.take<int32_t>((size_t)total * EI_N);
    list = cv.take<int>(total);
    qx = cv.take<uint8_t>((size_t)total * RES);
    py = cv.take<uint8_t>((size_t)total * RES);
    n_listed = cv.take<int>(4);
  }
};

// Copy one env's slots of one pool (cap slots of EF_N floats and EI_N
// ints) into the staged arrays at slot ``at``; the caller synchronises.
__device__ __forceinline__ void load_slots(const float* __restrict__ f_g,
                                           const int32_t* __restrict__ i_g,
                                           int64_t env, int cap, int at,
                                           SlotTables& t) {
  for (int k = threadIdx.x; k < cap * EF_N; k += blockDim.x)
    t.sf[at * EF_N + k] = f_g[env * cap * EF_N + k];
  for (int k = threadIdx.x; k < cap * EI_N; k += blockDim.x)
    t.si[at * EI_N + k] = i_g[env * cap * EI_N + k];
}

// Step 1, by one whole warp after the slots are staged: list the slots
// that paint, in slot order, the entity pool's first.  Slot k < cap is
// entity slot k (painted if k < n_ent, into canvas min(z, nz - 1)); slot
// k >= cap is decor slot k - cap (if below n_dec, into nz + min(z, nzd -
// 1)).  A slot whose canvas is never composited, or whose span is empty on
// either axis, is left out: its blends change nothing that is shown.  The
// caller synchronises.
__device__ __forceinline__ void compact_slots(SlotTables& t, int cap,
                                              int dcap, int n_ent, int n_dec,
                                              int nz, int nzd,
                                              const CanvasOrder& order, int S,
                                              int n_rows) {
  const int lane = threadIdx.x & 31;
  const int total = cap + dcap;
  int n = 0;
  for (int k0 = 0; k0 < total; k0 += 32) {
    const int k = k0 + lane;
    bool on = false;
    int zc = -1, span = 0;
    if (k < total) {
      const int32_t* e = t.si + k * EI_N;
      const float* f = t.sf + k * EF_N;
      const bool dec = k >= cap;
      const int z = e[EI_Z];
      on = (dec ? k - cap < n_dec : k < n_ent) && e[EI_LIVE] > 0 && z >= 0;
      zc = order.of(dec ? nz + (z < nzd - 1 ? z : nzd - 1)
                        : (z < nz - 1 ? z : nz - 1));
      int xlo, xhi, ylo, yhi;
      axis_span(f[EF_X0], f[EF_W2], &xlo, &xhi);
      axis_span(f[EF_Y0], f[EF_H2], &ylo, &yhi);
      on = on && zc >= 0 && xlo <= xhi && ylo <= yhi;
      if (on) span = xlo | xhi << 8 | ylo << 16 | yhi << 24;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (on) {
      const int j = n + __popc(ballot & ((1u << lane) - 1u));
      const int32_t* e = t.si + k * EI_N;
      const float* f = t.sf + k * EF_N;
      SlotPaint s;
      s.texel0 = clampi(e[EI_ROW], 0, n_rows - 1) * S * S;
      s.zc = zc;
      s.fb = e[EI_FB] > 0;
      s.span = span;
      s.alpha = f[EF_ALPHA] * INV255;  // alpha * f32(1/255), per slot
#pragma unroll
      for (int c = 0; c < 3; ++c) s.rgb[c] = f[EF_R + c];
      t.paint[j] = s;
      t.list[j] = k;
    }
    n += __popc(ballot);
  }
  if (lane == 0) *t.n_listed = n;
}

// Zero the row masks of pools of ``total`` slots, before compact_slots's
// synchronisation (axis_tables sets their bits).
__device__ __forceinline__ void clear_masks(SlotTables& t, int total) {
  for (int k = threadIdx.x; k < RES * mask_words(total); k += blockDim.x)
    t.mask[k] = 0u;
}

// Step 2, by the whole block after compact_slots: the per-axis texel
// tables and the row masks.  Entry (j, e) is list slot j's column e or,
// for e >= RES, its row e - RES, so consecutive threads share a slot;
// only entries inside the slot's span are evaluated.  The caller
// synchronises.
__device__ __forceinline__ void axis_tables(SlotTables& t, int S) {
  const int n = *t.n_listed;
  const int words = mask_words(n);
  for (int idx = threadIdx.x; idx < n * 2 * RES; idx += blockDim.x) {
    const int j = idx / (2 * RES), e = idx % (2 * RES);
    const bool y = e >= RES;
    const int pix = y ? e - RES : e;
    const int span = t.paint[j].span >> (y ? 16 : 0);
    uint8_t* table = (y ? t.py : t.qx) + j * RES + pix;
    if (pix < (span & 255) || pix > ((span >> 8) & 255)) {
      *table = OUTSIDE;
      continue;
    }
    const float* f = t.sf + t.list[j] * EF_N;
    const int32_t* si = t.si + t.list[j] * EI_N;
    bool valid;
    const int ix = y ? axis_index((float)pix + 0.5f, f[EF_Y0], f[EF_H2], si[EI_NTV],
                                  si[EI_TILEV], si[EI_PFLIP], S, &valid)
                     : axis_index((float)pix + 0.5f, f[EF_X0], f[EF_W2], si[EI_NTH],
                                  si[EI_TILEH], si[EI_QFLIP], S, &valid);
    *table = valid ? (uint8_t)ix : OUTSIDE;
    if (y && valid) atomicOr(t.mask + pix * words + j / 32, 1u << (j % 32));
  }
}

// Zero a pixel's canvases.
__device__ __forceinline__ void clear_canvases(float canv[MAX_CANVASES][4]) {
#pragma unroll
  for (int z = 0; z < MAX_CANVASES; ++z)
#pragma unroll
    for (int c = 0; c < 4; ++c) canv[z][c] = 0.f;
}

// One slot's blend into one premultiplied canvas, rounded to bf16.
__device__ __forceinline__ void blend(float cv[4], const float rgb[3], float a) {
  const float keep = 1.f - a;
#pragma unroll
  for (int c = 0; c < 3; ++c) cv[c] = bf16_round(rgb[c] * a + cv[c] * keep);
  cv[3] = bf16_round(a + cv[3] * keep);
}

// Step 3: paint the listed slots that cover pixel (row, col) into its
// canvases, in slot order; false if none does (the canvases stay 0).
// atlas: uint8 [n_rows, S, S, 4] as RGBA words.
__device__ __forceinline__ bool paint_pixel(const SlotTables& t, int row,
                                            int col,
                                            const uchar4* __restrict__ atlas,
                                            int S, float canv[MAX_CANVASES][4]) {
  const int words = mask_words(*t.n_listed);
  const uint32_t* m = t.mask + row * words;
  bool painted = false;
  for (int w = 0; w < words; ++w) {
    for (unsigned bits = m[w]; bits != 0u; bits &= bits - 1u) {
      const int j = w * 32 + __ffs(bits) - 1;
      const int q = t.qx[j * RES + col];
      if (q == OUTSIDE) continue;
      const SlotPaint& s = t.paint[j];
      float rgb[3], a;
      if (s.fb) {
        a = 1.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = s.rgb[c];
      } else {
        const int p = t.py[j * RES + row];
        const uchar4 tx = __ldg(atlas + s.texel0 + p * S + q);
        // (texel * (alpha * f32(1/255))) * cover, cover = 1
        a = (float)tx.w * s.alpha;
        rgb[0] = (float)tx.x;
        rgb[1] = (float)tx.y;
        rgb[2] = (float)tx.z;
      }
      switch (s.zc) {  // the same for the whole warp: a branch, not a select
        case 0: blend(canv[0], rgb, a); break;
        case 1: blend(canv[1], rgb, a); break;
        case 2: blend(canv[2], rgb, a); break;
        default: blend(canv[3], rgb, a); break;
      }
      painted = true;
    }
  }
  return painted;
}

// Composite the canvases at places [lo, hi) of the composite order over
// one channel value, each round(rgb + obs * (1 - a)); the places are
// compile-time indices, so the canvases stay in registers.  Where no lane
// of the warp painted (``painted`` false), every canvas is 0 and each
// composite is round(0 + obs * 1) = round(obs), so one round stands for
// them all.
__device__ __forceinline__ float composite_range(float o,
                                                 float canv[MAX_CANVASES][4],
                                                 int lo, int hi, int c,
                                                 bool painted) {
  if (!painted) return hi > lo ? rintf(o) : o;
#pragma unroll
  for (int k = 0; k < MAX_CANVASES; ++k)
    if (k >= lo && k < hi) o = rintf(canv[k][c] + o * (1.f - canv[k][3]));
  return o;
}

// Copy one env's 12 KiB frame between device and shared memory, 16 bytes
// a thread and access (the wrappers pass frames that start on 16 bytes,
// and a frame is 768 such words).
__device__ __forceinline__ void copy_frame(uint8_t* __restrict__ dst,
                                           const uint8_t* __restrict__ src) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int k = threadIdx.x; k < FRAME_BYTES / 16; k += blockDim.x) d[k] = s[k];
}

// Let ``kernel`` take ``smem`` bytes of dynamic shared memory: above 48 KB
// a kernel has to ask for it.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)
             : cudaSuccess;
}

// A compiled kernel's resources at ``smem`` bytes of dynamic shared memory
// and ``threads`` a block: out[0] registers a thread, out[1] local (spill)
// bytes a thread, out[2] the dynamic shared memory, out[3] blocks resident
// per SM.  Returns a cudaError.
template <class Kernel>
int occupancy(Kernel kernel, size_t smem, int threads, int* out) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess) e = allow_smem(kernel, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return (int)e;
}

}  // namespace pgt
