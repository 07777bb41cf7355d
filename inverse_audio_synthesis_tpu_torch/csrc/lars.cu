// One LARS step (lightning-flash's rule at zero momentum, with the non-finite
// guard) over every float32 parameter tensor of a model, for Hopper (sm_90a), in
// three launches: lars_norm_kernel, lars_fold_kernel, lars_update_kernel.
//
// Replaces no Pallas kernel: the JAX package leaves its fused_lars
// (train/optim.py) to XLA, which fuses each tensor's elementwise ops. The plain
// PyTorch step ran ~18 kernels a tensor (casts, two norms, five broadcasts of 0-dim
// tensors, the add), ~3,200 launches and 76 bytes moved a parameter per step.
//
// What bounds it on an H100: bytes. LARS needs two passes, since every element's
// update waits for its tensor's norms: read g and w for the norms (8 bytes a
// float32 parameter), then read g and w and write w (12 bytes). At 3.35 TB/s that
// is 20 bytes a parameter, ~1 ms for the 173M parameters of vicreg-full. The
// operations (~8 a parameter) are far below the float32 pipe's rate.
//
// The design, for that bound:
//   - A static chunk map: each tensor is cut into chunks of CHUNK elements,
//     numbered on from the tensor's first_chunk, so chunk c belongs to the last
//     tensor whose first_chunk is <= c (a binary search over the parameter
//     table). The norm and update passes run as many blocks as fit on the card at
//     once, each walking the chunks c = blockIdx.x, blockIdx.x + gridDim.x, ...:
//     every SM streams, whatever the tensors' sizes.
//   - 16-byte loads where a chunk's gradient and weight are 16-byte aligned
//     (8-byte for a bf16 gradient); element loads otherwise (a gradient viewed out
//     of a flat all-reduce bucket). Each thread takes the same elements in the same
//     order either way, so the sums do not depend on the alignment. A thread issues
//     the loads of BATCH strides of g and w before it uses any (BATCH 1 to 8
//     measured within 2% of each other: 1.225 ms for BATCH 1, 1.207 for 4, the
//     three launches at vicreg-full's parameters, CUDA events, L2 flushed).
//   - The parameter table (pointers, sizes, first chunks, flags) is written to
//     the device once, when the optimizer is built. The gradients change from
//     one eager step to the next, so their pointers travel in the launch's own
//     parameters (a CUDA graph captures them by value): no copy from the host, no
//     allocation, no synchronisation in a step.
//   - No float atomics. The norm pass writes one pair of partial sums of squares
//     (g, w) per chunk; the fold, one block, sums each tensor's partials in double
//     in a fixed order. Two launches give the same bits, and a graph's replay the
//     eager step's.
//   - The gradient's bf16 rounding under grads_bf16 is done in registers
//     (__float2bfloat16_rn, then back: the bits of g.to(bfloat16).float()), in
//     both passes, instead of a cast kernel that writes a bf16 copy. A bf16
//     gradient (weights_bf16) is read as it is.
//
// Rounding. The fold computes each tensor's factors with the single float32
// operations, in the order, of the plain version (ops/lars.py:factors_plain):
// local_lr = tc*||w|| / ((||g|| + wd*||w||) + eps) where ||w|| > 0 and ||g|| > 0,
// else 1 (and the decay factor 0). The update pass computes, per element,
// w + (ok ? (-lr) * (local_lr * (g + wdc * w)) : 0), each product and sum rounded
// on its own (--fmad=false), as the plain version's separate kernels round them;
// tensors LARS does not adapt (weight decay 0, or excluded) take w + (-lr) * g.
// Given the same norms, the update is the plain version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16384;  // elements a chunk; ops/lars.py:CHUNK
constexpr int THREADS = 256;  // norm and update passes
constexpr int VEC = 4;        // elements a thread loads at a time
constexpr int STRIDE = THREADS * VEC;
constexpr int BATCH = 4;  // a thread's loads in flight together: BATCH x VEC elements of g and w
constexpr int FOLD_THREADS = 1024;
constexpr int FLAG_LARS = 1;   // the tensor's update is adapted and decayed
constexpr int FLAG_ROUND = 2;  // its float32 gradient is rounded to bf16 first

// Tensors a launch takes: their gradients' addresses and dtype flags travel in
// the launch's parameters, 9 bytes a tensor, under the 4 KB of a launch
// (ops/lars.py:MAX_TENSORS; the pretraining models have 171 and 174).
constexpr int MAX_TENSORS = 384;

// One row of the parameter table; ops/lars.py packs it as three int64 words.
struct TensorInfo {
  float* w;
  long long numel;
  int first_chunk;
  int flags;
};
static_assert(sizeof(TensorInfo) == 24, "ops/lars.py packs the table as 3 int64 words a tensor");

struct Grads {
  const void* ptr[MAX_TENSORS];
  unsigned char bf16[MAX_TENSORS];  // 1: the gradient is bf16, 0: float32
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Up to VEC elements of a gradient from element i of a chunk of `len`, as float32.
template <typename G>
__device__ __forceinline__ void load_g(const G* g, int i, int len, bool vec, float (&out)[VEC]);

template <>
__device__ __forceinline__ void load_g<float>(const float* g, int i, int len, bool vec,
                                              float (&out)[VEC]) {
  if (vec && i + VEC <= len) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(g + i));
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = i + k < len ? __ldg(g + i + k) : 0.0f;
  }
}

template <>
__device__ __forceinline__ void load_g<__nv_bfloat16>(const __nv_bfloat16* g, int i, int len,
                                                      bool vec, float (&out)[VEC]) {
  if (vec && i + VEC <= len) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(g + i));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    out[0] = __low2float(lo), out[1] = __high2float(lo);
    out[2] = __low2float(hi), out[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = i + k < len ? __bfloat162float(g[i + k]) : 0.0f;
  }
}

__device__ __forceinline__ void load_w(const float* w, int i, int len, bool vec,
                                       float (&out)[VEC]) {
  if (vec && i + VEC <= len) {
    const float4 v = *reinterpret_cast<const float4*>(w + i);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = i + k < len ? w[i + k] : 0.0f;
  }
}

__device__ __forceinline__ void store_w(float* w, int i, int len, bool vec, const float (&v)[VEC]) {
  if (vec && i + VEC <= len) {
    *reinterpret_cast<float4*>(w + i) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (i + k < len) w[i + k] = v[k];
  }
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

// Where chunk c lies: its tensor's row, its first element and its length.
struct Chunk {
  TensorInfo t;
  int tensor;
  long long start;
  int len;
};

__device__ __forceinline__ Chunk chunk_at(const TensorInfo* __restrict__ info, int n_tensors,
                                          int c) {
  // the last tensor whose first chunk is <= c (first chunks rise strictly from 0)
  int lo = 0, hi = n_tensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (info[mid].first_chunk <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  Chunk k;
  k.tensor = lo;
  k.t = info[k.tensor];
  k.start = (long long)(c - k.t.first_chunk) * CHUNK;
  k.len = (int)min((long long)CHUNK, k.t.numel - k.start);
  return k;
}

// The sums of squares of one chunk's gradient (rounded where the flag says) and,
// for an adapted tensor, its weight, this thread's share.
template <typename G>
__device__ __forceinline__ void chunk_sums(const Chunk& k, const void* gp, float& gs, float& ws) {
  const G* g = static_cast<const G*>(gp) + k.start;
  const float* w = k.t.w + k.start;
  const bool lars = k.t.flags & FLAG_LARS, to_bf16 = k.t.flags & FLAG_ROUND;
  const bool vec = aligned(g, VEC * sizeof(G)) && aligned(w, VEC * sizeof(float));
  for (int i = threadIdx.x * VEC; i < k.len; i += BATCH * STRIDE) {
    float gv[BATCH][VEC], wv[BATCH][VEC];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) load_g<G>(g, i + b * STRIDE, k.len, vec, gv[b]);
    if (lars) {
#pragma unroll
      for (int b = 0; b < BATCH; ++b) load_w(w, i + b * STRIDE, k.len, vec, wv[b]);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float x = to_bf16 ? round_bf16(gv[b][e]) : gv[b][e];
        gs = __fmaf_rn(x, x, gs);
      }
      if (lars) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) ws = __fmaf_rn(wv[b][e], wv[b][e], ws);
      }
    }
  }
}

// The block's sum of v (fixed order: a butterfly in each warp, then warp 0 over
// the warps' sums), valid in thread 0. `scratch` holds THREADS / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int k = 0; k < THREADS / 32; ++k) s += scratch[k];
  return s;
}

__global__ void __launch_bounds__(THREADS)
lars_norm_kernel(Grads grads, const TensorInfo* __restrict__ info, int n_tensors, int n_chunks,
                 float2* __restrict__ partials) {
  __shared__ float scratch[2][THREADS / 32];
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk k = chunk_at(info, n_tensors, c);
    float gs = 0.0f, ws = 0.0f;
    if (grads.bf16[k.tensor])
      chunk_sums<__nv_bfloat16>(k, grads.ptr[k.tensor], gs, ws);
    else
      chunk_sums<float>(k, grads.ptr[k.tensor], gs, ws);
    gs = block_sum(gs, scratch[0]);
    ws = block_sum(ws, scratch[1]);
    if (threadIdx.x == 0) partials[c] = make_float2(gs, ws);
    __syncthreads();  // scratch is free for the next chunk
  }
}

// One block. Warp v folds tensors v, v + 32, ...: its lanes sum every 32nd
// partial in double, then a butterfly; lane 0's sum is the tensor's. Then the
// guard, each tensor's factors, the step's -lr and ok flag, and the count.
__global__ void __launch_bounds__(FOLD_THREADS)
lars_fold_kernel(const float2* __restrict__ partials, const TensorInfo* __restrict__ info,
                 int n_tensors, int n_chunks, float wd, float tc, float eps,
                 const float* __restrict__ lr, const bool* __restrict__ agreed, int* count,
                 int* total_notfinite, float2* __restrict__ norms, float2* __restrict__ factors,
                 float* __restrict__ step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool bad = false;
  for (int t = warp; t < n_tensors; t += FOLD_THREADS / 32) {
    const int begin = info[t].first_chunk;
    const int end = t + 1 < n_tensors ? info[t + 1].first_chunk : n_chunks;
    double gs = 0.0, ws = 0.0;
    for (int c = begin + lane; c < end; c += 32) {
      const float2 p = partials[c];
      gs += (double)p.x;
      ws += (double)p.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gs += __shfl_xor_sync(0xffffffffu, gs, o);
      ws += __shfl_xor_sync(0xffffffffu, ws, o);
    }
    if (lane == 0) {
      const float gn = (float)sqrt(gs), wn = (float)sqrt(ws);
      norms[t] = make_float2(gn, wn);
      bad = bad || !isfinite(gn) || !isfinite(wn);
    }
  }
  // the barrier also makes the norms written above visible to the whole block
  const bool ok = !__syncthreads_or(bad) && (agreed == nullptr || *agreed);
  for (int t = threadIdx.x; t < n_tensors; t += FOLD_THREADS) {
    float local_lr = 1.0f, wdc = 0.0f;
    if (info[t].flags & FLAG_LARS) {
      const float gn = norms[t].x, wn = norms[t].y;
      const bool cond = wn > 0.0f && gn > 0.0f;
      const float num = tc * wn;
      const float den = (gn + wd * wn) + eps;
      if (cond) local_lr = num / den, wdc = wd;
    }
    factors[t] = make_float2(local_lr, wdc);
  }
  if (threadIdx.x == 0) {
    step[0] = -*lr;
    step[1] = ok ? 1.0f : 0.0f;
    *count += ok ? 1 : 0;
    *total_notfinite += ok ? 0 : 1;
  }
}

template <typename G>
__device__ __forceinline__ void chunk_update(const Chunk& k, const void* gp, float2 f, float neglr,
                                             bool ok) {
  const G* g = static_cast<const G*>(gp) + k.start;
  float* w = k.t.w + k.start;
  const bool lars = k.t.flags & FLAG_LARS, to_bf16 = k.t.flags & FLAG_ROUND;
  const bool vec = aligned(g, VEC * sizeof(G)) && aligned(w, VEC * sizeof(float));
  for (int i = threadIdx.x * VEC; i < k.len; i += BATCH * STRIDE) {
    float gv[BATCH][VEC], wv[BATCH][VEC];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      load_g<G>(g, i + b * STRIDE, k.len, vec, gv[b]);
      load_w(w, i + b * STRIDE, k.len, vec, wv[b]);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float x = to_bf16 ? round_bf16(gv[b][e]) : gv[b][e];
        const float upd = lars ? neglr * (f.x * (x + f.y * wv[b][e])) : neglr * x;
        wv[b][e] = wv[b][e] + (ok ? upd : 0.0f);
      }
      store_w(w, i + b * STRIDE, k.len, vec, wv[b]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
lars_update_kernel(Grads grads, const TensorInfo* __restrict__ info, int n_tensors,
                   int n_chunks, const float2* __restrict__ factors,
                   const float* __restrict__ step) {
  const float neglr = step[0];
  const bool ok = step[1] != 0.0f;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk k = chunk_at(info, n_tensors, c);
    const float2 f = factors[k.tensor];
    if (grads.bf16[k.tensor])
      chunk_update<__nv_bfloat16>(k, grads.ptr[k.tensor], f, neglr, ok);
    else
      chunk_update<float>(k, grads.ptr[k.tensor], f, neglr, ok);
  }
}

// As many blocks as fit on the card at once, and no more than there are chunks.
template <typename Kernel>
int grid_for(Kernel kernel, int n_chunks, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  *blocks = min(n_chunks, sms * per_sm);
  return (int)err;
}

Grads grads_of(const void* const* ptrs, const unsigned char* bf16, int n) {
  Grads g = {};
  for (int t = 0; t < n; ++t) g.ptr[t] = ptrs[t], g.bf16[t] = bf16[t];
  return g;
}

bool takes(int n_tensors, int n_chunks) {
  return n_tensors >= 1 && n_tensors <= MAX_TENSORS && n_chunks >= n_tensors;
}

}  // namespace

// The three launches of one step on `stream`; each returns the cudaError_t of its
// launch (0 on success). `grads` and `bf16` are host arrays of n_tensors gradient
// pointers (contiguous, as many elements as their parameters) and dtype flags;
// `info` is the device table of n_tensors rows (TensorInfo), whose chunks number
// n_chunks in all; `partials` n_chunks float2 (g, w sums of
// squares); `norms` and `factors` n_tensors float2 ((||g||, ||w||) and (local_lr,
// decay factor)); `step` 2 floats (-lr and the ok flag); `lr` a device float,
// `agreed` a device bool or null, `count` and `total_notfinite` device int32.
extern "C" int lars_norm_launch(const void* const* grads, const unsigned char* bf16, int n_tensors,
                                const void* info, int n_chunks, void* partials, void* stream) {
  int blocks = 0;
  if (!takes(n_tensors, n_chunks)) return (int)cudaErrorInvalidValue;
  const int err = grid_for(lars_norm_kernel, n_chunks, &blocks);
  if (err != 0) return err;
  lars_norm_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grads_of(grads, bf16, n_tensors), static_cast<const TensorInfo*>(info), n_tensors, n_chunks,
      static_cast<float2*>(partials));
  return (int)cudaGetLastError();
}

extern "C" int lars_fold_launch(const void* partials, const void* info, int n_tensors, int n_chunks,
                                float wd, float tc, float eps, const float* lr, const bool* agreed,
                                int* count, int* total_notfinite, void* norms, void* factors,
                                float* step, void* stream) {
  if (!takes(n_tensors, n_chunks)) return (int)cudaErrorInvalidValue;
  lars_fold_kernel<<<1, FOLD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(partials), static_cast<const TensorInfo*>(info), n_tensors,
      n_chunks, wd, tc, eps, lr, agreed, count, total_notfinite, static_cast<float2*>(norms),
      static_cast<float2*>(factors), step);
  return (int)cudaGetLastError();
}

extern "C" int lars_update_launch(const void* const* grads, const unsigned char* bf16,
                                  int n_tensors, const void* info, int n_chunks,
                                  const void* factors, const float* step, void* stream) {
  int blocks = 0;
  if (!takes(n_tensors, n_chunks)) return (int)cudaErrorInvalidValue;
  const int err = grid_for(lars_update_kernel, n_chunks, &blocks);
  if (err != 0) return err;
  lars_update_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grads_of(grads, bf16, n_tensors), static_cast<const TensorInfo*>(info), n_tensors, n_chunks,
      static_cast<const float2*>(factors), step);
  return (int)cudaGetLastError();
}

extern "C" int lars_chunk() { return CHUNK; }

extern "C" int lars_max_tensors() { return MAX_TENSORS; }

// Resident blocks per SM of the norm and update passes (needs the card).
extern "C" int lars_occupancy(int update) {
  int blocks = 0;
  const cudaError_t err =
      update ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lars_update_kernel, THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lars_norm_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -1;
}
