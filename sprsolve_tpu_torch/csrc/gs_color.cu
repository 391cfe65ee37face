// One Gauss-Seidel colour step on a 3-D grid for Hopper (sm_90a): the
// smoother of the injection multigrid V-cycle
// (sprsolve_tpu_torch/multigrid.py, InjectionMGPrecond).
//
// Layout: the padded DIA layout of dia_spmv.cu (h zeros | n_pad body
// entries | h zeros; bands (D, n_pad), zero outside the matrix).  The body's
// first nx * ny * nz rows are the points of an (nx, ny, nz) grid, x-major,
// z fastest.  Colour c = 4 * (ix & 1) + 2 * (iy & 1) + (iz & 1): on an
// operator whose every nonzero couples points at most 1 apart in each
// coordinate (the 27-point stencil and anything inside it), two points of
// one colour never couple, so a step over one colour is exact Gauss-Seidel
// on those rows, and its rows may run in any order.
//
// gs_color_step_kernel<V, B, FIRST> sets, for the rows i of one colour,
//     z[i] <- z[i] + (r[i] - sum_d band_d[i] * z[i + off_d]) / band_diag[i]
// and leaves every other row of z as it is.  The row sum runs over the bands
// in order d = 0 .. nd - 1 as acc = fma(widen(band), z, acc) from 0 (madd),
// K1's order, so a row's result depends on nothing but its inputs: not on
// the grid of blocks.  FIRST is the step that starts from z = 0: it writes
// z[i] = r[i] / band_diag[i] and reads no z and no other band (the caller
// has zeroed z).
//
// The step writes z in place while it reads it.  A row reads only its own
// z (the diagonal term, before it writes it) and z of rows of other
// colours, which no thread of the launch writes.  A band that is zero at a
// row may point at a row of the same colour (a flat offset that wraps at a
// grid edge); its product is zero whatever that row holds, as long as z is
// finite.
//
// One thread per colour row, blocks of STEP_THREADS; a warp takes 32
// points along z, rows 2 apart, so its band, r and z loads are strided by
// two entries.  HBM bytes: the least a step needs is its colour's band
// rows, all of z once and its rows of r and z (37 n bytes in f64 with 27
// bands); the stride-2 loads read the bands' sectors twice over that.
// The launcher allocates nothing, never synchronises, launches on the
// caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_DIAGS 32      // as dia_spmv.cu
#define ROW_TILE 256      // n_pad is a multiple of it, as dia_spmv.cu
#define STEP_THREADS 256  // threads of a colour-step block

namespace {

struct Offsets {
  long long off[MAX_DIAGS];
  int nd;
};

template <typename V, typename B>
__device__ __forceinline__ V widen(B b) {
  return static_cast<V>(b);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 b) {
  return __bfloat162float(b);
}

__device__ __forceinline__ float madd(float b, float x, float acc) { return __fmaf_rn(b, x, acc); }
__device__ __forceinline__ double madd(double b, double x, double acc) { return __fma_rn(b, x, acc); }

// The colour's points are (cx + 2 jx, cy + 2 jy, cz + 2 jz), jx < mx,
// jy < my, jz < mz; thread t takes jz = t % mz, then jy, then jx.
// base = cx * sx + cy * sy + cz, sx = ny * nz, sy = nz.
template <typename V, typename B, bool FIRST>
__global__ void __launch_bounds__(STEP_THREADS)
gs_color_step_kernel(const B* __restrict__ bands, V* z, const V* __restrict__ r,
                     long long n_pad, long long h, unsigned mx, unsigned my,
                     unsigned mz, long long sx, long long sy, long long base,
                     int diag, Offsets offs) {
  const unsigned t = blockIdx.x * STEP_THREADS + threadIdx.x;
  if (t >= mx * my * mz) return;
  const unsigned jz = t % mz;
  const unsigned q = t / mz;
  const unsigned jy = q % my;
  const unsigned jx = q / my;
  const long long i = base + 2 * ((long long)jx * sx + (long long)jy * sy + jz);
  const V a = widen<V>(bands[(long long)diag * n_pad + i]);
  if (FIRST) {
    z[h + i] = r[h + i] / a;
    return;
  }
  const V* zi = z + h + i;
  V acc = V(0);
#pragma unroll
  for (int d = 0; d < MAX_DIAGS; ++d) {
    if (d >= offs.nd) break;
    acc = madd(widen<V>(bands[(long long)d * n_pad + i]), zi[offs.off[d]], acc);
  }
  z[h + i] = zi[0] + (r[h + i] - acc) / a;
}

template <typename V, typename B>
void launch_step(const void* bands, void* z, const void* r, long long n_pad, long long h,
                 unsigned mx, unsigned my, unsigned mz, long long sx, long long sy,
                 long long base, int diag, const Offsets& o, bool first, cudaStream_t s) {
  const unsigned m = mx * my * mz;
  const unsigned blocks = (m + STEP_THREADS - 1) / STEP_THREADS;
  const B* b = static_cast<const B*>(bands);
  V* zz = static_cast<V*>(z);
  const V* rr = static_cast<const V*>(r);
  if (first)
    gs_color_step_kernel<V, B, true><<<blocks, STEP_THREADS, 0, s>>>(
        b, zz, rr, n_pad, h, mx, my, mz, sx, sy, base, diag, o);
  else
    gs_color_step_kernel<V, B, false><<<blocks, STEP_THREADS, 0, s>>>(
        b, zz, rr, n_pad, h, mx, my, mz, sx, sy, base, diag, o);
}

}  // namespace

// Type codes as dia_spmv.cu: vcode 0 = f32, 1 = f64 vectors; bcode 0 = bands
// of the vector type, 1 = bf16, 2 = int8 (both for f32 vectors only).
// grid (nx, ny, nz): nx * ny * nz <= n_pad body rows; color in [0, 8);
// diag: the index of the band at offset 0.  A colour with no point launches
// nothing.
extern "C" int sprsolve_gs_color_step(int vcode, int bcode, const void* bands, void* z,
                                      const void* r, long long n_pad, long long h,
                                      long long nx, long long ny, long long nz, int color,
                                      const long long* offsets, int nd, int diag,
                                      int first, void* stream) {
  if (nd < 1 || nd > MAX_DIAGS || diag < 0 || diag >= nd || n_pad <= 0 ||
      n_pad % ROW_TILE != 0 || h < 0 || h > n_pad || nx < 1 || ny < 1 || nz < 1 ||
      nx * ny * nz > n_pad || nx * ny * nz > 0xffffff00LL || color < 0 || color > 7)
    return (int)cudaErrorInvalidValue;
  const long long cx = (color >> 2) & 1, cy = (color >> 1) & 1, cz = color & 1;
  const unsigned mx = (unsigned)((nx - cx + 1) / 2), my = (unsigned)((ny - cy + 1) / 2),
                 mz = (unsigned)((nz - cz + 1) / 2);
  if ((long long)mx * my * mz == 0) return 0;
  Offsets o;
  o.nd = nd;
  for (int d = 0; d < MAX_DIAGS; ++d) o.off[d] = d < nd ? offsets[d] : 0;
  const long long sx = ny * nz, sy = nz, base = cx * sx + cy * sy + cz;
  cudaStream_t s = (cudaStream_t)stream;
  const bool f = first != 0;
  if (vcode == 0 && bcode == 0) launch_step<float, float>(bands, z, r, n_pad, h, mx, my, mz, sx, sy, base, diag, o, f, s);
  else if (vcode == 0 && bcode == 1) launch_step<float, __nv_bfloat16>(bands, z, r, n_pad, h, mx, my, mz, sx, sy, base, diag, o, f, s);
  else if (vcode == 0 && bcode == 2) launch_step<float, int8_t>(bands, z, r, n_pad, h, mx, my, mz, sx, sy, base, diag, o, f, s);
  else if (vcode == 1 && bcode == 0) launch_step<double, double>(bands, z, r, n_pad, h, mx, my, mz, sx, sy, base, diag, o, f, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
