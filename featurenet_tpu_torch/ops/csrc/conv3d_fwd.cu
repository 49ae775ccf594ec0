// Stride-1 SAME 3D convolution forward, odd K, fp32 in / fp32 accumulate /
// fp32 out, for Hopper (sm_90a).
//
// Replaces featurenet_tpu/ops/conv3d.py::_conv_fwd (Pallas body
// _fwd_kernel): out[b,z,y,x,:] = sum over taps (dz,dy,dx) of
//   x[b, z+dz-p, y+dy-p, x+dx-p, :] @ w[dz,dy,dx]      (p = (K-1)/2)
// with zero padding outside the grid. Layouts are the JAX ones: x NDHWC,
// w DHWIO ([K,K,K,Cin,Cout]), out NDHWC; all contiguous. The same kernel
// computes the input gradient with the flipped kernel.
//
// What bounds it on this card: operations. sprint64's 3^3 blocks at 16^3 do
// 2*27*Cin flops per output value, about 450 flop/byte for 64->64, far
// above the H100's ~20 flop/byte fp32 ridge (67 TF/s non-tensor fp32 over
// 3.35 TB/s). Fed in turns (scalar halo-checked gathers, a transposed store,
// a barrier, the FMAs), the staging set the pace instead: 18-27 TF/s on an
// H100 SXM at 700 W. Staged as below it runs 36-40 TF/s there at sprint64's
// batch-256 shapes (55-60 % of the fp32 peak); what is left is the rate at
// which FMAs dispatch beside the shared-memory reads, one barrier per
// chunk, and the L2 reads of x (each row is staged once per tap, 27 times,
// which costs the 32-column tiles a few per cent against the 64-column
// ones):
//
// - The conv is an implicit GEMM: rows are output positions
//   (M = B*D*H*W), columns are Cout, the contraction runs over taps x Cin,
//   walked as one flat sequence of chunks: tap-major, then kBK channels.
//   Each block owns a BM x BN output tile and never shares it.
// - Staging is asynchronous. A (kBK channels of the tap-shifted x rows,
//   m-major, since ci is the contiguous axis of x) and B (kBK rows of
//   w[tap], n-contiguous) go to shared memory with cp.async into a ring of
//   kStages chunks; while chunk c's FMAs run, chunks c+1 .. c+kStages-1 are
//   in flight. One barrier per chunk. Two chunks (a double buffer) beat
//   three by 2 % and four by 7 %: the copies come from L2 and land in time.
// - Where Cin and Cout are multiples of 4 and x and w are 16-byte aligned,
//   one 16-byte cp.async.cg moves 4 consecutive channels of one position
//   in one tap, neighbouring threads neighbouring pieces of one position;
//   otherwise a 4-byte cp.async.ca moves one value. The caller picks the
//   width (VEC) before the launch; both are instances of one kernel.
// - The halo, rows past M and channels past Cin are zero-filled by
//   cp.async itself (source size 0, source address the tensor base): no
//   branchy scalar path, no padded copy of x, and every thread commits the
//   same copy groups.
// - No decode on the critical path. The block's rows are decoded to
//   (z,y,x) once, into shared memory; each thread stages a fixed set of
//   rows and turns their coordinates into a validity bit mask once per
//   tap. Per chunk the loader steps its channel, tap and offsets with no
//   division.
// - Each thread accumulates an 8 x 8 register tile (rows strided by BM/8,
//   columns in two halves of 4), in SIMT fp32 FMAs: per 4 channels it reads
//   8 float4 of A along k and 8 float4 of B along n for 256 FMAs. A's row
//   stride needs no pad: a quarter-warp reads at most 2 distinct
//   neighbouring rows, 16 floats apart, so they never share a bank. A grid
//   with fewer blocks than SMs (serving's small buckets) takes a tile a
//   quarter the size, 128 threads of 8 x 4 outputs: twice the threads for
//   the same work, where the 8 x 8 tile leaves most SMs idle.
// - No TF32: one TF32 pass keeps a 10-bit mantissa (~1e-3 relative), far
//   from the fp32 sum the TPU kernel and the plain version give.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 8;         // output rows per thread
constexpr int kBK = 16;        // input channels per chunk (the A row stride)
constexpr int kStages = 2;     // chunks in the shared-memory ring
constexpr int kMinBlocks = 2;  // resident 256-thread blocks per SM (registers)
constexpr int kOutside = -(1 << 28);  // coordinate that fails every bound

template <int VEC>
__device__ __forceinline__ void cp_async_v(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? 4 * VEC : 0;  // 0: read nothing, fill zeros
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN, int TN>
__host__ __device__ constexpr int threads_of() {
  return (BM / kTM) * (BN / TN);
}

template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * (BM * kBK + kBK * BN) * (int)sizeof(float);
}

template <int BM, int BN, int TN, int VEC>
__global__ void __launch_bounds__(threads_of<BM, BN, TN>(),
                                  kMinBlocks * 256 / threads_of<BM, BN, TN>())
conv3d_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int B, int D, int H, int W,
                  int Cin, int Cout, int K) {
  constexpr int NT = threads_of<BM, BN, TN>();
  constexpr int TX = BN / TN, TY = BM / kTM;
  constexpr int STAGE = BM * kBK + kBK * BN;  // floats per ring slot
  constexpr int A_TPR = kBK / VEC;          // threads per staged row
  constexpr int A_RPP = NT / A_TPR;         // rows staged per pass
  constexpr int A_UPT = BM / A_RPP;         // rows each thread stages
  constexpr int B_UPR = BN / VEC;           // copies per B row
  constexpr int B_COPIES = kBK * B_UPR;
  constexpr int B_UPT = (B_COPIES + NT - 1) / NT;
  static_assert(NT % A_TPR == 0 && BM % A_RPP == 0 && A_UPT <= 32,
                "A staging split");
  static_assert(TN % 4 == 0 && kBK % 4 == 0, "float4 reads of A and B");
  static_assert(kBK % 32 != 0, "rows 32 floats apart would share banks");

  extern __shared__ __align__(16) float smem[];
  __shared__ int4 s_pos[BM];  // z, y, x of each row; kOutside past M

  const int tid = threadIdx.x;
  const long long M = (long long)B * D * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int p = (K - 1) / 2;

  for (int r = tid; r < BM; r += NT) {
    const long long m = m0 + r;
    int4 e = make_int4(kOutside, kOutside, kOutside, 0);
    if (m < M) {
      long long t = m;
      e.z = (int)(t % W);
      t /= W;
      e.y = (int)(t % H);
      t /= H;
      e.x = (int)(t % D);
    }
    s_pos[r] = e;
  }
  __syncthreads();  // s_pos

  // The loader's state: this thread's first staged row and channel piece,
  // and the chunk it stages next (channel l_c0 of tap (l_dz, l_dy, l_dx)).
  const int a_row = tid / A_TPR, a_c = (tid % A_TPR) * VEC;
  const float* xa = x + (m0 + a_row) * Cin + a_c;
  const long long a_step = (long long)A_RPP * Cin;
  int l_c0 = 0, l_dz = -p, l_dy = -p, l_dx = -p;
  long long l_xoff = (((long long)l_dz * H + l_dy) * W + l_dx) * Cin;
  const float* l_w = w + n0;  // w[tap][l_c0][n0]

  // Bit i: row a_row + i*A_RPP shifted by the loader's tap is in the grid.
  auto tap_mask = [&]() {
    unsigned mask = 0;
#pragma unroll
    for (int i = 0; i < A_UPT; ++i) {
      const int4 e = s_pos[a_row + i * A_RPP];
      const bool ok = (unsigned)(e.x + l_dz) < (unsigned)D &&
                      (unsigned)(e.y + l_dy) < (unsigned)H &&
                      (unsigned)(e.z + l_dx) < (unsigned)W;
      mask |= (unsigned)ok << i;
    }
    return mask;
  };
  unsigned l_mask = tap_mask();

  auto load_chunk = [&](int slot) {
    float* As = smem + slot * STAGE;
    float* Bs = As + BM * kBK;
    const bool c_ok = l_c0 + a_c < Cin;
    const float* src = xa + l_xoff + l_c0;
#pragma unroll
    for (int i = 0; i < A_UPT; ++i) {
      const bool ok = c_ok && ((l_mask >> i) & 1u);
      cp_async_v<VEC>(As + (a_row + i * A_RPP) * kBK + a_c,
                      ok ? src + i * a_step : x, ok);
    }
#pragma unroll
    for (int u = 0; u < B_UPT; ++u) {
      const int i = tid + u * NT;
      if (B_COPIES % NT == 0 || i < B_COPIES) {
        const int k = i / B_UPR, col = (i % B_UPR) * VEC;
        const bool ok = l_c0 + k < Cin && n0 + col < Cout;
        cp_async_v<VEC>(Bs + k * BN + col,
                        ok ? l_w + (long long)k * Cout + col : w, ok);
      }
    }
    l_c0 += kBK;
    l_w += (long long)kBK * Cout;
    if (l_c0 >= Cin) {  // next tap: w rows follow on, dx steps fastest
      l_w += (long long)(Cin - l_c0) * Cout;
      l_c0 = 0;
      if (++l_dx > p) {
        l_dx = -p;
        if (++l_dy > p) {
          l_dy = -p;
          ++l_dz;
        }
      }
      l_xoff = (((long long)l_dz * H + l_dy) * W + l_dx) * Cin;
      l_mask = tap_mask();
    }
  };

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int tx = tid % TX, ty = tid / TX;
  const int nchunks = K * K * K * ((Cin + kBK - 1) / kBK);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    // Chunk c has landed for every thread, and every thread is done with
    // chunk c-1, whose slot the load below refills.
    __syncthreads();
    const int nc = c + kStages - 1;
    if (nc < nchunks) load_chunk(nc % kStages);
    cp_async_commit();
    const float* As = smem + (c % kStages) * STAGE;
    const float* Bs = As + BM * kBK;
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float b[4][TN];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              Bs + (k + kk) * BN + h * TX * 4 + tx * 4);
          b[kk][4 * h] = v.x, b[kk][4 * h + 1] = v.y;
          b[kk][4 * h + 2] = v.z, b[kk][4 * h + 3] = v.w;
        }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(As + (i * TY + ty) * kBK + k);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[kk], b[kk][j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + i * TY + ty;
    if (m >= M) continue;
    float* o = out + m * Cout + n0;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = h * TX * 4 + tx * 4;
      if constexpr (VEC == 4) {  // Cout % 4 == 0: a piece is all in or out
        if (n0 + col < Cout)
          *reinterpret_cast<float4*>(o + col) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + col + j < Cout) o[col + j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int BM, int BN, int TN, int VEC>
int launch(const float* x, const float* w, float* out, int B, int D, int H,
           int W, int Cin, int Cout, int K, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BM, BN>();
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_fwd_kernel<BM, BN, TN, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * D * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((Cout + BN - 1) / BN));
  conv3d_fwd_kernel<BM, BN, TN, VEC>
      <<<grid, threads_of<BM, BN, TN>(), bytes, stream>>>(x, w, out, B, D, H,
                                                           W, Cin, Cout, K);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int TN>
int launch_tile(int vec, const float* x, const float* w, float* out, int B,
                int D, int H, int W, int Cin, int Cout, int K, cudaStream_t s) {
  if (vec == 4)
    return launch<BM, BN, TN, 4>(x, w, out, B, D, H, W, Cin, Cout, K, s);
  return launch<BM, BN, TN, 1>(x, w, out, B, D, H, W, Cin, Cout, K, s);
}

}  // namespace

// C entry bound with ctypes. (bm, bn) is the output tile the caller
// planned: (512, 32) or (256, 64), 256 threads of 8 x 8 outputs, or for a
// grid too small to fill the card (128, 32) or (64, 64), 128 threads of
// 8 x 4. `vec` is the copy width in
// floats: 4 needs Cin and Cout multiples of 4 and x, w and out 16-byte
// aligned, 1 takes anything. Launches on `stream` (PyTorch's current
// stream), does not synchronise, allocates nothing; returns
// cudaGetLastError() (or the error of a refused attribute) so the caller
// sees a refused launch.
extern "C" int conv3d_fwd_f32(const float* x, const float* w, float* out, int B,
                              int D, int H, int W, int Cin, int Cout, int K,
                              int bm, int bn, int vec, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || K < 1 ||
      K % 2 == 0)
    return (int)cudaErrorInvalidValue;
  if (!(vec == 1 ||
        (vec == 4 && Cin % 4 == 0 && Cout % 4 == 0 &&
         reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(w) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(out) % 16 == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 512 && bn == 32)
    return launch_tile<512, 32, 8>(vec, x, w, out, B, D, H, W, Cin, Cout, K, s);
  if (bm == 256 && bn == 64)
    return launch_tile<256, 64, 8>(vec, x, w, out, B, D, H, W, Cin, Cout, K, s);
  if (bm == 128 && bn == 32)
    return launch_tile<128, 32, 4>(vec, x, w, out, B, D, H, W, Cin, Cout, K, s);
  if (bm == 64 && bn == 64)
    return launch_tile<64, 64, 4>(vec, x, w, out, B, D, H, W, Cin, Cout, K, s);
  return (int)cudaErrorInvalidValue;
}
