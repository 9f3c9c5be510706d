// Temporally blocked k-sweep smoother for the 5-point operator, called from
// JAX through its foreign function interface (multigrid_petsc_tpu/ops/
// smooth5_cuda.py builds and registers it).
//
// One step of the polynomial smoother (damped Jacobi: alpha = omega,
// beta = 0; Chebyshev: the (alpha, beta) recurrence of
// solvers/smoothers.chebyshev) is
//
//     z = D^-1 (b - A u);   p = beta p + alpha z;   u = u + p.
//
// The plain XLA path reads and writes the whole level once per step. Here
// each block stages a TILE_Y x TILE_X tile plus an h-wide halo of u and b
// in shared memory (h = k, or k + 1 when the residual is emitted), runs the
// k steps there with a barrier between them, and writes the tile's u (and
// r = b - A u) once. After step s only the window shrunk by s is valid,
// which is why the halo is as wide as the step count. Blocks share nothing
// and overlap only in the halos they read.
//
// Coefficients are per-row columns (the tensor-product meshes of
// problems.stencil_coefficients): coef is (5, ny) = cs, cw, cc, ce, cn.
// Points outside the grid are the eliminated Dirichlet boundary and stay 0.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Mirrored by TILE_Y / TILE_X / MAX_SWEEPS in ops/smooth5_cuda.py.
constexpr int kTileY = 16;
constexpr int kTileX = 128;
constexpr int kMaxSweeps = 8;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
smooth5_kernel(const float* __restrict__ u, const float* __restrict__ b,
               const float* __restrict__ coef, const float* __restrict__ steps,
               int k, int ny, int nx, int zero_guess, int emit_r,
               float* __restrict__ u_out, float* __restrict__ r_out) {
  extern __shared__ float smem[];
  const int h = k + emit_r;
  const int wy = kTileY + 2 * h;
  const int wx = kTileX + 2 * h;
  const int wn = wy * wx;
  float* ua = smem;
  float* ub = ua + wn;
  float* bs = ub + wn;
  float* ps = bs + wn;
  float* cs = ps + wn;
  float* cw = cs + wy;
  float* cc = cw + wy;
  float* ce = cc + wy;
  float* cn = ce + wy;

  const int y0 = blockIdx.y * kTileY - h;
  const int x0 = blockIdx.x * kTileX - h;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;

  for (int i = tid; i < wy; i += kThreadsX * kThreadsY) {
    const int gy = y0 + i;
    const bool in = gy >= 0 && gy < ny;
    cs[i] = in ? coef[gy] : 0.0f;
    cw[i] = in ? coef[ny + gy] : 0.0f;
    cc[i] = in ? coef[2 * ny + gy] : 1.0f;
    ce[i] = in ? coef[3 * ny + gy] : 0.0f;
    cn[i] = in ? coef[4 * ny + gy] : 0.0f;
  }
  for (int i = ty; i < wy; i += kThreadsY) {
    const int gy = y0 + i;
    for (int j = tx; j < wx; j += kThreadsX) {
      const int gx = x0 + j;
      const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
      const size_t g = static_cast<size_t>(gy) * nx + gx;
      const int w = i * wx + j;
      ua[w] = (in && !zero_guess) ? u[g] : 0.0f;
      bs[w] = in ? b[g] : 0.0f;
      ps[w] = 0.0f;
    }
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    const float alpha = steps[2 * s];
    const float beta = steps[2 * s + 1];
    const int lo = s + 1;  // ring s of the window went stale in step s
    for (int i = ty; i < wy; i += kThreadsY) {
      const int gy = y0 + i;
      const bool row_ok = i >= lo && i < wy - lo && gy >= 0 && gy < ny;
      const float dinv = 1.0f / cc[i];
      for (int j = tx; j < wx; j += kThreadsX) {
        const int gx = x0 + j;
        const int w = i * wx + j;
        float v = ua[w];
        if (row_ok && j >= lo && j < wx - lo && gx >= 0 && gx < nx) {
          const float au = cc[i] * v + cs[i] * ua[w - wx] + cn[i] * ua[w + wx]
                           + cw[i] * ua[w - 1] + ce[i] * ua[w + 1];
          const float p = beta * ps[w] + alpha * (dinv * (bs[w] - au));
          ps[w] = p;
          v += p;
        }
        ub[w] = v;
      }
    }
    __syncthreads();
    float* t = ua;
    ua = ub;
    ub = t;
  }

  for (int ti = ty; ti < kTileY; ti += kThreadsY) {
    const int i = ti + h;
    const int gy = y0 + i;
    if (gy >= ny) break;
    for (int tj = tx; tj < kTileX; tj += kThreadsX) {
      const int j = tj + h;
      const int gx = x0 + j;
      if (gx >= nx) break;
      const size_t g = static_cast<size_t>(gy) * nx + gx;
      const int w = i * wx + j;
      const float v = ua[w];
      u_out[g] = v;
      if (emit_r) {
        const float au = cc[i] * v + cs[i] * ua[w - wx] + cn[i] * ua[w + wx]
                         + cw[i] * ua[w - 1] + ce[i] * ua[w + 1];
        r_out[g] = bs[w] - au;
      }
    }
  }
}

ffi::Error launch(cudaStream_t stream, const ffi::Buffer<ffi::F32>& u,
                  const ffi::Buffer<ffi::F32>& b,
                  const ffi::Buffer<ffi::F32>& coef,
                  const ffi::Buffer<ffi::F32>& steps, int32_t zero_guess,
                  float* u_out, float* r_out) {
  const auto dims = b.dimensions();
  if (dims.size() != 2 || u.dimensions().size() != 2 ||
      u.dimensions()[0] != dims[0] || u.dimensions()[1] != dims[1]) {
    return ffi::Error::InvalidArgument("smooth5: u and b must be (ny, nx)");
  }
  const int ny = static_cast<int>(dims[0]);
  const int nx = static_cast<int>(dims[1]);
  const auto cdims = coef.dimensions();
  if (cdims.size() != 2 || cdims[0] != 5 || cdims[1] != ny) {
    return ffi::Error::InvalidArgument("smooth5: coef must be (5, ny)");
  }
  const auto sdims = steps.dimensions();
  const int k = sdims.size() == 2 ? static_cast<int>(sdims[0]) : 0;
  if (k < 1 || k > kMaxSweeps || sdims[1] != 2) {
    return ffi::Error::InvalidArgument("smooth5: steps must be (k, 2), "
                                       "1 <= k <= 8");
  }
  const int emit_r = r_out != nullptr;
  const int h = k + emit_r;
  const size_t wy = kTileY + 2 * h;
  const size_t wx = kTileX + 2 * h;
  const size_t smem = (4 * wy * wx + 5 * wy) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      smooth5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY);
  const dim3 block(kThreadsX, kThreadsY);
  smooth5_kernel<<<grid, block, smem, stream>>>(
      u.typed_data(), b.typed_data(), coef.typed_data(), steps.typed_data(),
      k, ny, nx, zero_guess, emit_r, u_out, r_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error smooth5_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> u,
                        ffi::Buffer<ffi::F32> b, ffi::Buffer<ffi::F32> coef,
                        ffi::Buffer<ffi::F32> steps,
                        ffi::ResultBuffer<ffi::F32> u_out,
                        int32_t zero_guess) {
  return launch(stream, u, b, coef, steps, zero_guess,
                u_out->typed_data(), nullptr);
}

ffi::Error smooth5_res_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> u,
                            ffi::Buffer<ffi::F32> b,
                            ffi::Buffer<ffi::F32> coef,
                            ffi::Buffer<ffi::F32> steps,
                            ffi::ResultBuffer<ffi::F32> u_out,
                            ffi::ResultBuffer<ffi::F32> r_out,
                            int32_t zero_guess) {
  return launch(stream, u, b, coef, steps, zero_guess,
                u_out->typed_data(), r_out->typed_data());
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MgSmooth5, smooth5_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // u
                                  .Arg<ffi::Buffer<ffi::F32>>()  // b
                                  .Arg<ffi::Buffer<ffi::F32>>()  // coef
                                  .Arg<ffi::Buffer<ffi::F32>>()  // steps
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u_out
                                  .Attr<int32_t>("zero_guess"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(MgSmooth5Res, smooth5_res_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // u
                                  .Arg<ffi::Buffer<ffi::F32>>()  // b
                                  .Arg<ffi::Buffer<ffi::F32>>()  // coef
                                  .Arg<ffi::Buffer<ffi::F32>>()  // steps
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u_out
                                  .Ret<ffi::Buffer<ffi::F32>>()  // r_out
                                  .Attr<int32_t>("zero_guess"));
