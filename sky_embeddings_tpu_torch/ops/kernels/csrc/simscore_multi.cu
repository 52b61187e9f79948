// Multi-query weighted-cosine scoring of an embedding bank for Hopper (sm_90a):
//
//   dots  = X  · (W⊙T)ᵀ      (N, Q)
//   prods = X² · Wᵀ          (N, Q)
//   out   = dots / (sqrt(prods) · ‖t‖_w + 1e-6)
//
// Replaces the TPU kernel sky_embeddings_tpu/ops/kernels/simscore.py:
// weighted_bank_scores_multi_pallas (body _scores_multi_kernel). The bank X
// (N, D) is read in its storage dtype (bf16 or fp32) and upcast in
// registers; (W⊙T)ᵀ and Wᵀ (D, Q), ‖t‖_w (Q,) and every sum are fp32, the
// output (N, Q) fp32. The TPU layout (Q padded to 128 lanes, N to 1024-row tiles)
// is not carried over: ragged N, D and Q are masked in the kernel.
//
// Bound on the H100: bytes (the bank, read once) at small Q, fp32
// operations (4·N·D·Q) from Q ~ 10 on, since this first version runs on the
// CUDA cores, not the tensor cores. Design: a block owns BN = 128 bank rows
// and BQ = 8·TQ queries and walks D in stages of BD = 32 columns. Each
// stage's bank tile is upcast and stored transposed in shared memory (a
// thread's TM = 4 rows are one float4; an XOR swizzle keeps the transposed
// stores free of bank conflicts), beside the stage's columns of (W⊙T)ᵀ and
// Wᵀ for the block's queries, which the wrapper lays out (D, Q) so that
// they load coalesced and store without conflicts. The next stage's bank
// tile and query columns are loaded into registers while the current stage
// is consumed. Each of the 256 threads keeps TM x TQ (dot, prod) pairs in
// registers and does two fp32 FMAs per (row, query, column). Queries past
// BQ take further blocks along grid y, so any Q fits in registers; TQ in
// {1, 2, 4, 8} is chosen from Q so that small Q wastes little work. At
// small Q the shared-memory loads and the instruction rate, not the bytes,
// set the time; tensor cores (a bf16 split of the fp32 operands, or TF32)
// and more rows per thread are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BN = 128;   // bank rows per block
constexpr int BD = 32;    // columns per stage
constexpr int TM = 4;     // rows per thread
constexpr int QG = 8;     // thread groups along the query axis (THREADS / QG * TM == BN)
constexpr int PER_THREAD = BN * BD / THREADS;  // bank elements a thread stages
static_assert(THREADS / QG * TM == BN, "thread layout must cover BN rows");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The values of one 16-byte load, upcast to fp32 (exact for bf16: its bits
// are the high half of the fp32 bits).
__device__ __forceinline__ void unpack(const uint4& r, float* v, float) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* v, __nv_bfloat16) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Where row r of column c of a stage lies in shared memory: XOR-ing bits 3-4
// of the row with the column's group of 8 spreads the transposed stores of
// a warp (8 rows x 4 column groups) over all 32 banks, and keeps each run
// of 4 rows (a thread's float4) together and aligned.
__device__ __forceinline__ int swizzle(int r, int c) { return r ^ ((c / 8) * 8); }

// One stage's (BN, BD) bank tile in registers, upcast to fp32. VEC: 16-byte
// loads (needs D a multiple of 16 / sizeof(T) and an aligned bank, so a
// segment lies wholly inside or outside D); otherwise one element a load,
// neighbouring threads on neighbouring columns.
template <typename T, bool VEC>
struct BankStage {
  static constexpr int SEG = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int LOADS = PER_THREAD / SEG;
  float v[PER_THREAD];

  __device__ __forceinline__ void load(const T* __restrict__ bank, int64_t n0, int d0, int64_t N,
                                       int D, int tid) {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int e = (tid + j * THREADS) * SEG;
      const int64_t n = n0 + e / BD;
      const int d = d0 + e % BD;
      const bool in = n < N && d < D;
      if constexpr (VEC) {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (in) raw = __ldg(reinterpret_cast<const uint4*>(bank + n * D + d));
        unpack(raw, v + j * SEG, T());
      } else {
        v[j] = in ? to_f32(bank[n * D + d]) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float (*xs)[BN], int tid) const {
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int e = (tid + j * THREADS) * SEG + i;
        xs[e % BD][swizzle(e / BD, e % BD)] = v[j * SEG + i];
      }
    }
  }
};

// One stage's (BD, BQ) columns of (W⊙T)ᵀ and Wᵀ in registers, zero past Q
// and D (they add nothing): BQ * BD = THREADS * TQ values of each, TQ a
// thread, neighbouring threads on neighbouring queries.
template <int TQ>
struct QueryStage {
  static constexpr int BQ = QG * TQ;
  float a[TQ], b[TQ];

  __device__ __forceinline__ void load(const float* __restrict__ wt, const float* __restrict__ w,
                                       int d0, int q0, int D, int Q, int tid) {
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int e = tid + j * THREADS;
      const int q = e % BQ, c = e / BQ;
      const bool in = q0 + q < Q && d0 + c < D;
      const int64_t off = static_cast<int64_t>(d0 + c) * Q + q0 + q;
      a[j] = in ? __ldg(wt + off) : 0.f;
      b[j] = in ? __ldg(w + off) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*wts)[BQ], float (*ws)[BQ], int tid) const {
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int e = tid + j * THREADS;
      wts[e / BQ][e % BQ] = a[j];
      ws[e / BQ][e % BQ] = b[j];
    }
  }
};

template <typename T, bool VEC, int TQ>
__global__ void __launch_bounds__(THREADS)
scores_multi_kernel(const T* __restrict__ bank, const float* __restrict__ wt,
                    const float* __restrict__ w, const float* __restrict__ tnorm,
                    float* __restrict__ out, int64_t N, int D, int Q) {
  constexpr int BQ = QG * TQ;
  __shared__ __align__(16) float xs[BD][BN];
  __shared__ __align__(16) float wts[BD][BQ];
  __shared__ __align__(16) float ws[BD][BQ];

  const int tid = threadIdx.x;
  const int tq = tid % QG;  // this thread's queries: q0 + tq * TQ + [0, TQ)
  const int tm = tid / QG;  // this thread's rows:    n0 + tm * TM + [0, TM)
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int q0 = blockIdx.y * BQ;

  float dot[TM][TQ], prod[TM][TQ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TQ; ++q) dot[i][q] = prod[i][q] = 0.f;

  BankStage<T, VEC> stage;
  QueryStage<TQ> qstage;
  stage.load(bank, n0, 0, N, D, tid);
  qstage.load(wt, w, 0, q0, D, Q, tid);
  for (int d0 = 0; d0 < D; d0 += BD) {
    __syncthreads();  // every thread is done with the previous stage
    stage.store(xs, tid);
    qstage.store(wts, ws, tid);
    __syncthreads();
    if (d0 + BD < D) {  // the next stage's loads in flight while this one computes
      stage.load(bank, n0, d0 + BD, N, D, tid);
      qstage.load(wt, w, d0 + BD, q0, D, Q, tid);
    }
#pragma unroll 4
    for (int c = 0; c < BD; ++c) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[c][swizzle(tm * TM, c)]);
      const float x[TM] = {xv.x, xv.y, xv.z, xv.w};
      float a[TQ], b[TQ];
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        a[q] = wts[c][tq * TQ + q];
        b[q] = ws[c][tq * TQ + q];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x2 = x[i] * x[i];
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
          dot[i][q] = fmaf(x[i], a[q], dot[i][q]);
          prod[i][q] = fmaf(x2, b[q], prod[i][q]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t n = n0 + tm * TM + i;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      const int qq = q0 + tq * TQ + q;
      if (qq < Q) out[n * Q + qq] = dot[i][q] / (sqrtf(prod[i][q]) * tnorm[qq] + 1e-6f);
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch_t(const void* bank, const float* wt, const float* w, const float* tnorm,
                     float* out, int64_t N, int D, int Q, cudaStream_t s) {
  const T* x = static_cast<const T*>(bank);
  const unsigned gx = static_cast<unsigned>((N + BN - 1) / BN);
  if (Q <= 8) {
    scores_multi_kernel<T, VEC, 1><<<dim3(gx, (Q + 7) / 8), THREADS, 0, s>>>(x, wt, w, tnorm, out, N, D, Q);
  } else if (Q <= 16) {
    scores_multi_kernel<T, VEC, 2><<<dim3(gx, (Q + 15) / 16), THREADS, 0, s>>>(x, wt, w, tnorm, out, N, D, Q);
  } else if (Q <= 32) {
    scores_multi_kernel<T, VEC, 4><<<dim3(gx, (Q + 31) / 32), THREADS, 0, s>>>(x, wt, w, tnorm, out, N, D, Q);
  } else {
    scores_multi_kernel<T, VEC, 8><<<dim3(gx, (Q + 63) / 64), THREADS, 0, s>>>(x, wt, w, tnorm, out, N, D, Q);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* bank, const float* wt, const float* w, const float* tnorm,
                   float* out, int64_t N, int D, int Q, cudaStream_t s) {
  constexpr int seg = 16 / static_cast<int>(sizeof(T));
  const bool vec = D % seg == 0 && reinterpret_cast<uintptr_t>(bank) % 16 == 0;
  return vec ? launch_t<T, true>(bank, wt, w, tnorm, out, N, D, Q, s)
             : launch_t<T, false>(bank, wt, w, tnorm, out, N, D, Q, s);
}

}  // namespace

// bank (N, D) bf16 (bank_bf16 = 1) or fp32, row-major; wt = (W⊙T)ᵀ and
// w = Wᵀ, (D, Q) fp32 row-major, so a stage's query columns load
// coalesced and store to shared memory without bank conflicts; tnorm (Q,)
// fp32; out (N, Q) fp32. Returns 0, or the CUDA error the launch reported.
extern "C" int sky_scores_multi(const void* bank, int bank_bf16, const void* wt, const void* w,
                                const void* tnorm, void* out, long long N, int D, int Q,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wt_ = static_cast<const float*>(wt);
  const float* w_ = static_cast<const float*>(w);
  const float* tn = static_cast<const float*>(tnorm);
  float* o = static_cast<float*>(out);
  const cudaError_t err =
      bank_bf16 ? launch<__nv_bfloat16>(bank, wt_, w_, tn, o, N, D, Q, s)
                : launch<float>(bank, wt_, w_, tn, o, N, D, Q, s);
  return static_cast<int>(err);
}
