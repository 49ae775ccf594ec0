// Weight gradient of the stride-1 SAME 3D convolution, odd K, fp32 in /
// fp32 accumulate / fp32 out, for Hopper (sm_90a).
//
// Replaces featurenet_tpu/ops/conv3d.py::_conv_dw (Pallas body _dw_kernel):
//   dW[dz,dy,dx,ci,co] = sum over positions (b,z,y,x) of
//       x[b, z+dz-p, y+dy-p, x+dx-p, ci] * g[b, z, y, x, co]   (p = (K-1)/2)
// with zero padding outside the grid. Layouts are the JAX ones: x NDHWC
// ([B,D,H,W,Cin]), g NDHWC ([B,D,H,W,Cout]), dW DHWIO ([K,K,K,Cin,Cout]);
// all contiguous.
//
// What bounds it on this card: operations (2*K^3*Cin*Cout flops per
// position against (Cin+Cout)*4 bytes read; several hundred flop/byte at
// sprint64's shapes, far above the ~20 flop/byte fp32 ridge). The sum runs
// over M = B*D*H*W positions (about a million at batch 256) into an output
// of only K^3*Cin*Cout values (at most 110,592 here), so tiles over the
// output alone give a handful of blocks for 132 SMs. The TPU kernel carries
// its sum across a sequential batch grid; GPU blocks run in parallel and in
// no order. So:
//
// - The GEMM is dW[(tap,ci), co] = sum_m A[m, (tap,ci)] * g[m, co], with
//   A[m, (tap,ci)] the tap-shifted input. A block owns a BM x BN tile of
//   (tap,ci) rows x Cout columns and one slab of positions; the caller
//   plans S slabs so that tiles x S fill whole waves of resident blocks.
// - Each block writes its partial tile to part[slab][(tap,ci)][co]; a second
//   kernel sums the S partials of each output in slab order. Two runs give
//   the same bits (atomics would not).
//
// The position sum is also latency-bound if it is fed in turns: decode a
// chunk's positions, gather them behind halo checks, wait at a barrier, run
// the FMAs. Measured that way it reached 8-14 TF/s. So the FMAs are kept
// fed:
//
// - Staging is asynchronous. A (the tap-shifted x rows) and B (g) go to
//   shared memory with cp.async into a ring of kStages chunks of kBK
//   positions; while chunk c's FMAs run, chunks c+1 .. c+kStages-1 are in
//   flight. One barrier per chunk.
// - Where Cin and Cout are multiples of 4 and both bases are 16-byte
//   aligned, one 16-byte cp.async.cg moves 4 consecutive ci of one tap at one
//   position (contiguous in NDHWC, never across a tap); otherwise a 4-byte
//   cp.async.ca moves one value. The caller picks the width (VEC) before the
//   launch; both are instances of the same kernel.
// - The halo, positions past the slab and rows or columns past the output
//   are zero-filled by cp.async itself (source size 0, source address the
//   tensor base): no branchy scalar path, no padded copy of x.
// - Each thread stages one position per chunk. It decodes that position
//   once per block in 64-bit and then steps its (z,y,x) by kBK in 32-bit as
//   it issues each chunk; no warp waits on another's divisions. A row's
//   tap shift and channel come from a table built once per block.
// - Each of the 256 threads accumulates an 8 x 8 register tile (rows and
//   columns split in two halves of 4, so a warp's float4 reads of A and B
//   are contiguous), in SIMT fp32 FMAs. No TF32: one TF32 pass keeps a
//   10-bit mantissa (~1e-3 relative), far from the fp32 sum the TPU kernel
//   and the plain version give.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 8;      // output rows per thread
constexpr int kTN = 8;      // output columns per thread
constexpr int kBK = 16;     // positions per chunk
constexpr int kStages = 3;  // chunks in the shared-memory ring
constexpr int kMinBlocks = 2;  // resident blocks per SM the registers allow
constexpr int kAPad = 4;    // A row stride (BM+4)*4 bytes: a multiple of 16
constexpr int kOutside = -(1 << 28);  // shift that fails every bound
constexpr int kSumThreads = 256;

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

template <int BM, int BN>
__host__ __device__ constexpr int threads_of() {
  return (BM / kTM) * (BN / kTN);
}

template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * kBK * (BM + kAPad + BN) * (int)sizeof(float);
}

template <int BM, int BN, int VEC>
__global__ void __launch_bounds__(threads_of<BM, BN>(), kMinBlocks)
conv3d_dw_partial(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ part, int B, int D, int H, int W,
                  int Cin, int Cout, int K, long long slab_len) {
  constexpr int NT = threads_of<BM, BN>();
  constexpr int TX = BN / kTN, TY = BM / kTM;
  constexpr int AS = BM + kAPad;            // A row stride, floats
  constexpr int STAGE = kBK * (AS + BN);    // floats per ring slot
  constexpr int A_UNITS = BM / VEC;         // copies per A chunk row
  constexpr int A_TPP = NT / kBK;           // threads per staged position
  constexpr int A_UPT = A_UNITS / A_TPP;    // A copies per thread per chunk
  constexpr int B_UNITS = BN / VEC;
  constexpr int B_COPIES = kBK * B_UNITS;
  static_assert(NT % kBK == 0 && A_UNITS % A_TPP == 0, "A staging split");
  static_assert(kTM % 4 == 0 && kTN % 4 == 0, "float4 fragment reads");

  extern __shared__ __align__(16) float smem[];
  __shared__ int4 s_row[A_UNITS];  // per A unit: x offset, dz, dy, dx

  const int tid = threadIdx.x;
  const int rows = K * K * K * Cin;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)B * D * H * W;
  const long long m_begin = (long long)blockIdx.z * slab_len;
  const long long m_end = m_begin + slab_len < M ? m_begin + slab_len : M;
  const int nchunks = (int)((m_end - m_begin + kBK - 1) / kBK);

  for (int u = tid; u < A_UNITS; u += NT) {
    const int row = r0 + u * VEC;
    int4 e = make_int4(0, kOutside, kOutside, kOutside);
    if (row < rows) {
      const int p = (K - 1) / 2;
      const int tap = row / Cin, ci = row % Cin;
      e.y = tap / (K * K) - p;
      e.z = (tap / K) % K - p;
      e.w = tap % K - p;
      e.x = ((e.y * H + e.z) * W + e.w) * Cin + ci;
    }
    s_row[u] = e;
  }

  // The one position this thread stages in each chunk: decoded here once,
  // then stepped by kBK per chunk in 32-bit.
  const int a_k = tid / A_TPP, a_u0 = tid % A_TPP;
  long long a_m = m_begin + a_k;
  int pz = 0, py = 0, px = 0;
  if (a_m < M) {
    long long t = a_m;
    px = (int)(t % W);
    t /= W;
    py = (int)(t % H);
    t /= H;
    pz = (int)(t % D);
  }
  __syncthreads();  // s_row

  auto load_chunk = [&](int slot, long long c0) {
    float* As = smem + slot * STAGE;
    float* Bs = As + kBK * AS;
    const bool m_ok = a_m < m_end;
    const float* xm = x + a_m * Cin;
#pragma unroll
    for (int i = 0; i < A_UPT; ++i) {
      const int u = a_u0 + i * A_TPP;
      const int4 e = s_row[u];
      const bool ok = m_ok && (unsigned)(pz + e.y) < (unsigned)D &&
                      (unsigned)(py + e.z) < (unsigned)H &&
                      (unsigned)(px + e.w) < (unsigned)W;
      cp_async_v<VEC>(As + a_k * AS + u * VEC, ok ? xm + e.x : x, ok);
    }
#pragma unroll
    for (int i = tid; i < B_COPIES; i += NT) {
      const int k = i / B_UNITS, col = n0 + (i % B_UNITS) * VEC;
      const long long m = c0 + k;
      const bool ok = m < m_end && col < Cout;
      cp_async_v<VEC>(Bs + k * BN + (i % B_UNITS) * VEC,
                      ok ? g + m * Cout + col : g, ok);
    }
    a_m += kBK;
    px += kBK;
    if (px >= W) {
      int q = px / W;
      px -= q * W;
      py += q;
      if (py >= H) {
        q = py / H;
        py -= q * H;
        pz += q;
        if (pz >= D) pz %= D;
      }
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int tx = tid % TX, ty = tid / TX;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) load_chunk(s, m_begin + (long long)s * kBK);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    // Chunk c has landed for every thread, and every thread is done with
    // chunk c-1, whose slot the load below refills.
    __syncthreads();
    const int nc = c + kStages - 1;
    if (nc < nchunks) load_chunk(nc % kStages, m_begin + (long long)nc * kBK);
    cp_async_commit();
    const float* As = smem + (c % kStages) * STAGE;
    const float* Bs = As + kBK * AS;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM / 4; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(As + k * AS + i * TY * 4 + ty * 4);
        a[4 * i] = v.x, a[4 * i + 1] = v.y, a[4 * i + 2] = v.z, a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kTN / 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(Bs + k * BN + j * TX * 4 + tx * 4);
        b[4 * j] = v.x, b[4 * j + 1] = v.y, b[4 * j + 2] = v.z, b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* out = part + (long long)blockIdx.z * rows * Cout;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + (i / 4) * TY * 4 + ty * 4 + i % 4;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + (j / 4) * TX * 4 + tx * 4 + j % 4;
      if (n < Cout) out[(long long)r * Cout + n] = acc[i][j];
    }
  }
}

// out[i] = sum over s = 0..S-1, in that order, of part[s][i].
__global__ void __launch_bounds__(kSumThreads)
sum_slabs(const float* __restrict__ part, float* __restrict__ out, long long n,
          int S) {
  const long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += __ldg(part + (long long)k * n + i);
  out[i] = s;
}

template <int BM, int BN, int VEC>
int launch_partial(const float* x, const float* g, float* part, int B, int D,
                   int H, int W, int Cin, int Cout, int K, int S,
                   long long slab_len, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<BM, BN>();
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_dw_partial<BM, BN, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = K * K * K * Cin;
  const dim3 grid((unsigned)((rows + BM - 1) / BM),
                  (unsigned)((Cout + BN - 1) / BN), (unsigned)S);
  conv3d_dw_partial<BM, BN, VEC><<<grid, threads_of<BM, BN>(), bytes, stream>>>(
      x, g, part, B, D, H, W, Cin, Cout, K, slab_len);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_tile(int vec, const float* x, const float* g, float* part, int B,
                int D, int H, int W, int Cin, int Cout, int K, int S,
                long long slab_len, cudaStream_t s) {
  if (vec == 4)
    return launch_partial<BM, BN, 4>(x, g, part, B, D, H, W, Cin, Cout, K, S,
                                     slab_len, s);
  return launch_partial<BM, BN, 1>(x, g, part, B, D, H, W, Cin, Cout, K, S,
                                   slab_len, s);
}

}  // namespace

// C entry bound with ctypes. `part` is caller-allocated scratch of
// S * K^3 * Cin * Cout floats; slab s covers positions
// [s*slab_len, min((s+1)*slab_len, B*D*H*W)). (bm, bn) is the output tile
// the caller planned S with: (512, 32) or (256, 64). `vec` is the copy width
// in floats: 4 needs Cin and Cout multiples of 4 and x and g 16-byte
// aligned, 1 takes anything. Launches the partial kernel, then the slab sum,
// on `stream`; does not synchronise, allocates nothing; returns
// cudaGetLastError() (or the error of a refused attribute) so the caller
// sees a refused launch.
extern "C" int conv3d_dw_f32(const float* x, const float* g, float* part,
                             float* out, int B, int D, int H, int W, int Cin,
                             int Cout, int K, int bm, int bn, int vec, int S,
                             long long slab_len, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || K < 1 ||
      K % 2 == 0 || S < 1 || S > 65535 || slab_len < 1 ||
      (long long)(S - 1) * slab_len >= (long long)B * D * H * W)
    return (int)cudaErrorInvalidValue;
  if (!(vec == 1 ||
        (vec == 4 && Cin % 4 == 0 && Cout % 4 == 0 &&
         reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(g) % 16 == 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (bm == 512 && bn == 32)
    err = launch_tile<512, 32>(vec, x, g, part, B, D, H, W, Cin, Cout, K, S,
                               slab_len, s);
  else if (bm == 256 && bn == 64)
    err = launch_tile<256, 64>(vec, x, g, part, B, D, H, W, Cin, Cout, K, S,
                               slab_len, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  const long long n = (long long)K * K * K * Cin * Cout;
  sum_slabs<<<(unsigned)((n + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
              s>>>(part, out, n, S);
  return (int)cudaGetLastError();
}
