// Two-plane complex banded (DIA) SpMV kernels for Hopper (sm_90a): K5, K6
// and K7 of the port.
//
// Layout as in dia_spmv.cu: a vector is flat, h zeros | n_pad body entries |
// h zeros, with h >= max |offset| and n_pad a multiple of ROW_TILE; here the
// entries are complex, stored interleaved (re, im) as a contiguous
// complex64/complex128 tensor stores them, and read as float2/double2.  A
// complex matrix is two real band planes, A = A_re + i*A_im, each (D, n_pad)
// with the same offsets.  Each plane is stored in its own narrowest exact
// type (f32, bf16 or int8 for complex64 vectors; f64 for complex128) and is
// widened in registers, so a narrow plane gives the products of the same
// values stored wide, bit for bit.
//
// With u the SpMV input and, summed over the bands at the shifted position,
//   rr = A_re*u_re,  ii = A_im*u_im,  ri = A_re*u_im,  ir = A_im*u_re:
// K5  dia_complex_spmv_kernel replaces _dia_complex_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:244, wrapper _dia_complex_pallas_call
//     :447): y = A*x, y_re = rr - ii, y_im = ri + ir.
// K6  dia_complex_dot_kernel replaces _dia_complex_dot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:262, wrapper
//     _dia_complex_dotmv_pallas_call :305): K5 plus one pair of partials per
//     block, [sum xr*yr + xi*yi, sum xr*yi - xi*yr] = conj(x)^T y.  CONJ_X
//     computes y = A*conj(x) by a sign fold instead (y_re = rr + ii,
//     y_im = ir - ri; the x planes are read as they are); the same partial
//     expressions then give the Saunders alpha = conj(x)^T (A conj(x)).
// K7  dia_complex_wdot_kernel replaces _dia_complex_wdot_kernel
//     (sprsolve_tpu/ops/pallas_spmv.py:343, wrapper
//     _dia_complex_wdot_pallas_call :402): K5 on u = dinv*x (complex
//     product, HAS_DINV: the complex Jacobi fold) or on x, plus partials
//     [Re conj(w)^T y, Im conj(w)^T y, sum |y|^2] per block; with W_IS_X the
//     dot reads the raw x.
//
// What bounds them on an H100: HBM bytes.  Per row they move
// D * (re_bytes + im_bytes) of bands and 2 * vec_bytes (x and y), plus
// vec_bytes for dinv and for w (K7), at 8 flops per band -- far below any
// compute limit.  The design, as in dia_spmv.cu:
//  * one thread per row, ROW_TILE rows per block: both band planes, the x
//    body and y are read and written fully coalesced, x and y as one
//    8- or 16-byte load or store per row;
//  * the D shifted reads of x (and dinv) overlap between neighbouring rows
//    and bands and are served from L1/L2, so x costs about one HBM pass;
//  * each plane narrows on its own (the damped Poisson keeps an int8 real
//    and a bf16 imaginary plane), so the kernels are instantiated for every
//    pair of plane types: 10 pairs, 70 kernels in all;
//  * the four real sums are accumulated in one band loop and combined at
//    the end, as the TPU kernel does; no complex library type is used;
//  * the partials use the fixed reduction tree of dia_spmv.cu (block_sum,
//    copied here so that each source builds alone): one row of 2 or 3 real
//    partials per block, summed by the caller in a second step.  No float
//    atomics.
// The launchers allocate nothing and never synchronise; they launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ROW_TILE 256   // as in dia_spmv.cu and ops/padded_dia.py
#define MAX_DIAGS 32

namespace {

struct Offsets {
  long long off[MAX_DIAGS];
  int nd;
};

template <typename R>
struct Complex;
template <>
struct Complex<float> {
  using type = float2;
};
template <>
struct Complex<double> {
  using type = double2;
};
template <typename R>
using C = typename Complex<R>::type;

template <typename R>
__device__ __forceinline__ C<R> cplx(R re, R im) {
  C<R> v;
  v.x = re;
  v.y = im;
  return v;
}

template <typename V, typename B>
__device__ __forceinline__ V widen(B b) {
  return static_cast<V>(b);
}

template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 b) {
  return __bfloat162float(b);
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// dia_spmv.cu's block_sum: the block's sum in thread 0, in a fixed tree
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* smem) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = V(0);
  if (warp == 0) {
    v = lane < ROW_TILE / 32 ? smem[lane] : V(0);
    v = warp_sum(v);
  }
  return v;
}

template <typename R>
struct Sums {
  R rr, ii, ri, ir;
};

// the four real band sums of one row; xi (and di) point at row i's body
// entry, and u = x or, with HAS_DINV, u = dinv*x at each shifted position
template <typename R, typename BR, typename BI, bool HAS_DINV>
__device__ __forceinline__ Sums<R> complex_accumulate(
    const BR* __restrict__ bre, const BI* __restrict__ bim,
    const C<R>* __restrict__ xi, const C<R>* __restrict__ di, long long i,
    long long n_pad, const Offsets& offs) {
  Sums<R> s = {R(0), R(0), R(0), R(0)};
#pragma unroll
  for (int d = 0; d < MAX_DIAGS; ++d) {
    if (d >= offs.nd) break;
    const long long o = offs.off[d];
    const C<R> xv = xi[o];
    R ur = xv.x;
    R ui = xv.y;
    if (HAS_DINV) {
      const C<R> dv = di[o];
      ur = xv.x * dv.x - xv.y * dv.y;
      ui = xv.x * dv.y + xv.y * dv.x;
    }
    const long long k = (long long)d * n_pad + i;
    const R br = widen<R>(bre[k]);
    const R bi = widen<R>(bim[k]);
    s.rr = s.rr + br * ur;
    s.ii = s.ii + bi * ui;
    s.ri = s.ri + br * ui;
    s.ir = s.ir + bi * ur;
  }
  return s;
}

template <typename R>
__device__ __forceinline__ void clear_halo(C<R>* __restrict__ y, long long i,
                                           long long n_pad, long long h) {
  if (i < h) {  // h <= n_pad: the first h threads clear both halos
    y[i] = cplx<R>(R(0), R(0));
    y[h + n_pad + i] = cplx<R>(R(0), R(0));
  }
}

template <typename R, typename BR, typename BI>
__global__ void __launch_bounds__(ROW_TILE)
dia_complex_spmv_kernel(const BR* __restrict__ bre, const BI* __restrict__ bim,
                        const C<R>* __restrict__ x, C<R>* __restrict__ y,
                        long long n_pad, long long h, Offsets offs) {
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const Sums<R> s = complex_accumulate<R, BR, BI, false>(bre, bim, x + h + i,
                                                         nullptr, i, n_pad, offs);
  y[h + i] = cplx<R>(s.rr - s.ii, s.ri + s.ir);
  clear_halo<R>(y, i, n_pad, h);
}

template <typename R, typename BR, typename BI, bool CONJ_X>
__global__ void __launch_bounds__(ROW_TILE)
dia_complex_dot_kernel(const BR* __restrict__ bre, const BI* __restrict__ bim,
                       const C<R>* __restrict__ x, C<R>* __restrict__ y,
                       R* __restrict__ partials, long long n_pad, long long h,
                       Offsets offs) {
  __shared__ R s_re[ROW_TILE / 32];
  __shared__ R s_im[ROW_TILE / 32];
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const Sums<R> s = complex_accumulate<R, BR, BI, false>(bre, bim, x + h + i,
                                                         nullptr, i, n_pad, offs);
  const R yr = CONJ_X ? s.rr + s.ii : s.rr - s.ii;
  const R yi = CONJ_X ? s.ir - s.ri : s.ri + s.ir;
  y[h + i] = cplx<R>(yr, yi);
  clear_halo<R>(y, i, n_pad, h);
  const C<R> xv = x[h + i];
  const R pr = block_sum(xv.x * yr + xv.y * yi, s_re);
  const R pi = block_sum(xv.x * yi - xv.y * yr, s_im);
  if (threadIdx.x == 0) {
    partials[2 * (long long)blockIdx.x] = pr;
    partials[2 * (long long)blockIdx.x + 1] = pi;
  }
}

template <typename R, typename BR, typename BI, bool HAS_DINV, bool W_IS_X>
__global__ void __launch_bounds__(ROW_TILE)
dia_complex_wdot_kernel(const BR* __restrict__ bre, const BI* __restrict__ bim,
                        const C<R>* __restrict__ x, const C<R>* __restrict__ dinv,
                        const C<R>* __restrict__ w, C<R>* __restrict__ y,
                        R* __restrict__ partials, long long n_pad, long long h,
                        Offsets offs) {
  __shared__ R s_wr[ROW_TILE / 32];
  __shared__ R s_wi[ROW_TILE / 32];
  __shared__ R s_yy[ROW_TILE / 32];
  const long long i = (long long)blockIdx.x * ROW_TILE + threadIdx.x;
  const Sums<R> s = complex_accumulate<R, BR, BI, HAS_DINV>(
      bre, bim, x + h + i, HAS_DINV ? dinv + h + i : nullptr, i, n_pad, offs);
  const R yr = s.rr - s.ii;
  const R yi = s.ri + s.ir;
  y[h + i] = cplx<R>(yr, yi);
  clear_halo<R>(y, i, n_pad, h);
  const C<R> wv = W_IS_X ? x[h + i] : w[h + i];
  const R p0 = block_sum(wv.x * yr + wv.y * yi, s_wr);
  const R p1 = block_sum(wv.x * yi - wv.y * yr, s_wi);
  const R p2 = block_sum(yr * yr + yi * yi, s_yy);
  if (threadIdx.x == 0) {
    partials[3 * (long long)blockIdx.x] = p0;
    partials[3 * (long long)blockIdx.x + 1] = p1;
    partials[3 * (long long)blockIdx.x + 2] = p2;
  }
}

dim3 grid_of(long long n_pad) { return dim3((unsigned)(n_pad / ROW_TILE)); }

template <typename R, typename BR, typename BI>
struct SpmvLaunch {
  static void run(const void* bre, const void* bim, const void* x, void* y,
                  long long n_pad, long long h, const Offsets& o, cudaStream_t s) {
    dia_complex_spmv_kernel<R, BR, BI><<<grid_of(n_pad), ROW_TILE, 0, s>>>(
        (const BR*)bre, (const BI*)bim, (const C<R>*)x, (C<R>*)y, n_pad, h, o);
  }
};

template <typename R, typename BR, typename BI>
struct DotLaunch {
  static void run(bool conj_x, const void* bre, const void* bim, const void* x,
                  void* y, void* partials, long long n_pad, long long h,
                  const Offsets& o, cudaStream_t s) {
    const BR* br = (const BR*)bre;
    const BI* bi = (const BI*)bim;
    const C<R>* xv = (const C<R>*)x;
    C<R>* yv = (C<R>*)y;
    R* pv = (R*)partials;
    if (conj_x)
      dia_complex_dot_kernel<R, BR, BI, true><<<grid_of(n_pad), ROW_TILE, 0, s>>>(br, bi, xv, yv, pv, n_pad, h, o);
    else
      dia_complex_dot_kernel<R, BR, BI, false><<<grid_of(n_pad), ROW_TILE, 0, s>>>(br, bi, xv, yv, pv, n_pad, h, o);
  }
};

template <typename R, typename BR, typename BI>
struct WdotLaunch {
  static void run(const void* bre, const void* bim, const void* x,
                  const void* dinv, const void* w, void* y, void* partials,
                  long long n_pad, long long h, const Offsets& o, cudaStream_t s) {
    const dim3 g = grid_of(n_pad);
    const BR* br = (const BR*)bre;
    const BI* bi = (const BI*)bim;
    const C<R>* xv = (const C<R>*)x;
    const C<R>* dv = (const C<R>*)dinv;
    const C<R>* wv = (const C<R>*)w;
    C<R>* yv = (C<R>*)y;
    R* pv = (R*)partials;
    if (dinv && w)
      dia_complex_wdot_kernel<R, BR, BI, true, false><<<g, ROW_TILE, 0, s>>>(br, bi, xv, dv, wv, yv, pv, n_pad, h, o);
    else if (dinv)
      dia_complex_wdot_kernel<R, BR, BI, true, true><<<g, ROW_TILE, 0, s>>>(br, bi, xv, dv, wv, yv, pv, n_pad, h, o);
    else if (w)
      dia_complex_wdot_kernel<R, BR, BI, false, false><<<g, ROW_TILE, 0, s>>>(br, bi, xv, dv, wv, yv, pv, n_pad, h, o);
    else
      dia_complex_wdot_kernel<R, BR, BI, false, true><<<g, ROW_TILE, 0, s>>>(br, bi, xv, dv, wv, yv, pv, n_pad, h, o);
  }
};

// Runs L<R, BR, BI>::run(args...) for the vector type code and the two
// plane type codes; false for a combination the kernels do not take.
// vcode 0 = complex64 vectors with planes of code 0 = f32, 1 = bf16,
// 2 = int8 each; vcode 1 = complex128 vectors with f64 planes (code 0).
template <template <typename, typename, typename> class L, typename... A>
bool dispatch(int vcode, int re_code, int im_code, A... args) {
  if (vcode == 1) {
    if (re_code != 0 || im_code != 0) return false;
    L<double, double, double>::run(args...);
    return true;
  }
  if (vcode != 0) return false;
  switch (re_code * 3 + im_code) {
    case 0: L<float, float, float>::run(args...); return true;
    case 1: L<float, float, __nv_bfloat16>::run(args...); return true;
    case 2: L<float, float, int8_t>::run(args...); return true;
    case 3: L<float, __nv_bfloat16, float>::run(args...); return true;
    case 4: L<float, __nv_bfloat16, __nv_bfloat16>::run(args...); return true;
    case 5: L<float, __nv_bfloat16, int8_t>::run(args...); return true;
    case 6: L<float, int8_t, float>::run(args...); return true;
    case 7: L<float, int8_t, __nv_bfloat16>::run(args...); return true;
    case 8: L<float, int8_t, int8_t>::run(args...); return true;
    default: return false;
  }
}

Offsets make_offsets(const long long* offsets, int nd) {
  Offsets o;
  o.nd = nd;
  for (int d = 0; d < MAX_DIAGS; ++d) o.off[d] = d < nd ? offsets[d] : 0;
  return o;
}

bool bad_geometry(long long n_pad, long long h, int nd) {
  return nd < 0 || nd > MAX_DIAGS || n_pad <= 0 || n_pad % ROW_TILE != 0 ||
         h < 0 || h > n_pad || n_pad / ROW_TILE > 0x7fffffffLL;
}

bool bad_codes(int re_code, int im_code) {
  return re_code < 0 || re_code > 2 || im_code < 0 || im_code > 2;
}

}  // namespace

// Type codes as in dispatch() above; bre/bim are the two band planes.

extern "C" int sprsolve_dia_complex_spmv(int vcode, int re_code, int im_code,
                                         const void* bre, const void* bim,
                                         const void* x, void* y, long long n_pad,
                                         long long h, const long long* offsets,
                                         int nd, void* stream) {
  if (bad_geometry(n_pad, h, nd) || bad_codes(re_code, im_code))
    return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  if (!dispatch<SpmvLaunch>(vcode, re_code, im_code, bre, bim, x, y, n_pad, h,
                            o, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// partials: n_pad / ROW_TILE rows of 2 real values, [Re, Im] of conj(x)^T y.
extern "C" int sprsolve_dia_complex_dot(int vcode, int re_code, int im_code,
                                        int conj_x, const void* bre,
                                        const void* bim, const void* x, void* y,
                                        void* partials, long long n_pad,
                                        long long h, const long long* offsets,
                                        int nd, void* stream) {
  if (bad_geometry(n_pad, h, nd) || bad_codes(re_code, im_code))
    return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  if (!dispatch<DotLaunch>(vcode, re_code, im_code, conj_x != 0, bre, bim, x, y,
                           partials, n_pad, h, o, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dinv == nullptr: no Jacobi fold; w == nullptr: the dot reads x (w_is_x).
// partials: n_pad / ROW_TILE rows of 3 real values,
// [Re conj(w)^T y, Im conj(w)^T y, sum |y|^2].
extern "C" int sprsolve_dia_complex_wdot(int vcode, int re_code, int im_code,
                                         const void* bre, const void* bim,
                                         const void* x, const void* dinv,
                                         const void* w, void* y, void* partials,
                                         long long n_pad, long long h,
                                         const long long* offsets, int nd,
                                         void* stream) {
  if (bad_geometry(n_pad, h, nd) || bad_codes(re_code, im_code))
    return (int)cudaErrorInvalidValue;
  const Offsets o = make_offsets(offsets, nd);
  if (!dispatch<WdotLaunch>(vcode, re_code, im_code, bre, bim, x, dinv, w, y,
                            partials, n_pad, h, o, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
