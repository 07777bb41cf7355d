// Backward of the audio-rate render (render_fwd.cu), for Hopper (sm_90a).
//
// Replaces the TPU kernel inverse_audio_synthesis_tpu/ops/pallas/render.py:_bwd_kernel
// (launched by render_audio_fused_bwd), the hand-derived VJP of the forward render.
// Given the audio cotangent g [B, Ta] it returns, per segment (one control step of
// `ratio` samples), the cotangents of the three controls each upsampled sample
// reads (previous, left, next) for all 5 routed signals, and per voice the
// cotangents of the 11 scalars (base pitch, depth and initial phase of both VCOs,
// shape, partials, the three mixer levels). ops/render.py shift-adds the segment
// components into d_routed [B, 5, Tc], as the JAX wrapper does outside its kernel.
//
// What bounds it on an H100: it reads noise and g once (8 bytes per sample) and
// recomputes the forward phase, the oscillators and the backward chains, a few
// hundred float32 operations per sample: operations bound it (chip_smoke.py keeps
// the tally and the bound).
//
// Design.
//   - The phase is a prefix sum of dphi over the voice, so d(dphi)[u] is the
//     suffix sum of d(phase)[t] over t >= u: all 176,400 samples of a 4 s voice.
//     These sums are plain float32 sums (the mod-2pi wraps of the forward are
//     gradient-transparent), not wrapped.
//   - Blocks cannot pass a carry backwards in order, so there are two launches, as
//     in the forward: bwd_seg_kernel recomputes each segment's forward phase and
//     sums its d(phase); a block-wide suffix scan gives each segment the sum of the
//     later segments of its tile, and each tile its total. bwd_main_kernel folds
//     the totals of the later tiles (at most a few dozen adds), walks its segment
//     forward in time (phase recompute, oscillator and VCA cotangents, d(phase)
//     kept in shared memory), then backward in time (the suffix sum and the pitch
//     chain).
//   - The forward phase is recomputed exactly: from the segment means and final
//     wrapped offsets the forward saved, with the forward's increments and helpers
//     (render_common.cuh, --fmad=false). A phase off by a rounding would move sin
//     and cos and so every cotangent.
//   - The scalar cotangents are summed without atomics: per thread over its
//     samples, a shuffle tree per warp, warp totals in order, one partial per tile,
//     then bwd_fold_kernel adds the tiles in order. Runs repeat bit for bit, and
//     the plain version (ops/render.py:render_audio_bwd_plain) repeats every sum in
//     the same association.
//   - The masks are strict, as in the TPU kernel: the pitch clip passes gradient
//     only for 0 < pre < 127, a VCA only for u > 0.
//   - Padded segments (seg >= Tc in the last tile) have no samples and write zeros.
//   - g and the noise are loaded through shared memory, coalesced; once read, a
//     sample's slots hold its two d(phase) values for the backward walk.

#include "render_common.cuh"

namespace {

using namespace render;

constexpr int N_SCALARS = 11;  // used columns of the [B, 16] scalars

// Forward recompute of one sample and the cotangents that do not need the phase
// suffix sum. `acc` is the running residual prefix of the two phases.
struct SampleGrads {
  float dp1, dp2;          // d/d(phase) of VCO 1 and VCO 2
  float du1, du3, du4;     // d/d(vco_1_amp, vco_2_amp, noise_amp) at this sample
  float dl1, dl2, dl3;     // d/d(mixer levels)
  float dshape, dpartials;
};

__device__ __forceinline__ SampleGrads sample_grads(const Controls& ctl, const float* sc,
                                                    const float mean[2], const float offset[2],
                                                    float acc[2], float w, bool use_prev,
                                                    float ramp, float dphi_scale, float g,
                                                    float nz) {
  float phase[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    float d = phase_increment(ctl.at(2 * o, w, use_prev), sc[3 * o], sc[3 * o + 1], dphi_scale);
    acc[o] = acc[o] + (d - mean[o]);
    phase[o] = (mean[o] * ramp + acc[o]) + offset[o];
  }
  SampleGrads r;
  // VCO 1: sine
  float s1, c1;
  sincos_fast(phase[0] + sc[2], &s1, &c1);
  const float u1 = ctl.at(1, w, use_prev);
  const float a1 = fmaxf(u1, 0.0f);
  const float gl1 = g * sc[8];
  r.dl1 = (g * c1) * a1;
  r.du1 = (gl1 * c1) * (u1 > 0.0f ? 1.0f : 0.0f);
  r.dp1 = -(gl1 * a1) * s1;
  // VCO 2: square <-> saw morph
  float s2, c2;
  sincos_fast(phase[1] + sc[5], &s2, &c2);
  const float shape = sc[6], partials = sc[7];
  const float sq = tanh_fast(PI_F * partials * s2 / 2.0f);
  const float amod = 1.0f - shape / 2.0f;
  const float bmod = 1.0f + shape * c2;
  const float osc2 = amod * sq * bmod;
  const float u3 = ctl.at(3, w, use_prev);
  const float a2 = fmaxf(u3, 0.0f);
  const float gl2 = g * sc[9];
  r.dl2 = (g * osc2) * a2;
  const float dosc2 = gl2 * a2;
  r.du3 = (gl2 * osc2) * (u3 > 0.0f ? 1.0f : 0.0f);
  const float dsq = dosc2 * amod * bmod;
  const float dcos2 = dosc2 * amod * sq * shape;
  r.dshape = dosc2 * (amod * sq * c2 - 0.5f * sq * bmod);
  const float darg = dsq * (1.0f - sq * sq);  // tanh'
  r.dpartials = darg * (PI_F * s2 / 2.0f);
  const float dsin2 = darg * (PI_F * partials / 2.0f);
  r.dp2 = dsin2 * c2 - dcos2 * s2;
  // noise
  const float u4 = ctl.at(4, w, use_prev);
  r.dl3 = (g * nz) * fmaxf(u4, 0.0f);
  r.du4 = (g * sc[10] * nz) * (u4 > 0.0f ? 1.0f : 0.0f);
  return r;
}

// Block-wide inclusive suffix scan over the SEG_TILE threads: warp shuffles down,
// then the totals of the later warps added from the last one back.
// ops/render.py:_tile_inclusive_suffix repeats it.
__device__ __forceinline__ float block_inclusive_suffix(float v, float* warp_tot) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    float dn = __shfl_down_sync(FULL, v, off);
    if (lane + off < 32) v = v + dn;
  }
  if (lane == 0) warp_tot[warp] = v;
  __syncthreads();
  float suffix = 0.0f;
  for (int w = WARPS - 1; w > warp; --w) suffix = suffix + warp_tot[w];
  if (warp < WARPS - 1) v = suffix + v;
  return v;
}

__device__ __forceinline__ void load_segment_state(const float* seg_mean, const float* phase_offset,
                                                   int b, int tcp, int seg, float mean[2],
                                                   float offset[2]) {
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    size_t i = ((size_t)b * 2 + o) * tcp + seg;
    mean[o] = seg_mean[i];
    offset[o] = phase_offset[i];
  }
}

// Pass 1: per segment, the sum of d(phase) over its samples (in time order); per
// segment, the sum over the later segments of its tile; per tile, its total.
// Grid (n_tiles, B), block SEG_TILE, dynamic shared memory SEG_TILE * ratio floats.
__global__ void bwd_seg_kernel(const float* __restrict__ routed,
                               const float* __restrict__ scalars,
                               const float* __restrict__ g,             // [B, ta]
                               const float* __restrict__ seg_mean,      // [B, 2, tcp]
                               const float* __restrict__ phase_offset,  // [B, 2, tcp]
                               float* __restrict__ seg_suffix,          // [B, 2, tcp]
                               float* __restrict__ tile_total,          // [B, 2, n_tiles]
                               int tc, int ratio, float dphi_scale) {
  extern __shared__ float buf[];  // this tile's audio cotangent
  __shared__ float warp_tot[2][WARPS];
  __shared__ float incl_s[2][SEG_TILE];
  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n_tiles = gridDim.x, tcp = n_tiles * SEG_TILE;
  const int ta = tc * ratio;
  const int seg = tile * SEG_TILE + t;
  const int start = tile * SEG_TILE * ratio;
  const int len = min(SEG_TILE * ratio, ta - start);
  const float* grow = g + (size_t)b * ta + start;
  for (int i = t; i < len; i += SEG_TILE) buf[i] = grow[i];
  __syncthreads();

  float tot[2] = {0.0f, 0.0f};
  if (seg < tc) {
    const Controls ctl = controls_at(routed, b, tc, seg);
    const float* sc = scalars + (size_t)b * 16;
    float mean[2], offset[2], acc[2] = {0.0f, 0.0f};
    load_segment_state(seg_mean, phase_offset, b, tcp, seg, mean, offset);
    const float* g_seg = buf + t * ratio;
    for (int j = 0; j < ratio; ++j) {
      const float jw = interp_offset(j, ratio);
      const SampleGrads d = sample_grads(ctl, sc, mean, offset, acc, fabsf(jw), jw < 0.0f,
                                         (float)(j + 1), dphi_scale, g_seg[j], 0.0f);
      tot[0] = tot[0] + d.dp1;
      tot[1] = tot[1] + d.dp2;
    }
  }
#pragma unroll
  for (int o = 0; o < 2; ++o) incl_s[o][t] = block_inclusive_suffix(tot[o], warp_tot[o]);
  __syncthreads();
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    seg_suffix[((size_t)b * 2 + o) * tcp + seg] = t + 1 < SEG_TILE ? incl_s[o][t + 1] : 0.0f;
    if (t == 0) tile_total[((size_t)b * 2 + o) * n_tiles + tile] = incl_s[o][0];
  }
}

// Pass 2: all cotangents of one tile of one voice. Grid (n_tiles, B), block
// SEG_TILE, dynamic shared memory 2 * SEG_TILE * ratio floats.
__global__ void bwd_main_kernel(const float* __restrict__ routed,
                                const float* __restrict__ scalars,
                                const float* __restrict__ noise,         // [B, ta]
                                const float* __restrict__ g,             // [B, ta]
                                const float* __restrict__ seg_mean,      // [B, 2, tcp]
                                const float* __restrict__ phase_offset,  // [B, 2, tcp]
                                const float* __restrict__ seg_suffix,    // [B, 2, tcp]
                                const float* __restrict__ tile_total,    // [B, 2, n_tiles]
                                float* __restrict__ d_seg,               // [B, 5, 3, tcp]
                                float* __restrict__ d_part,              // [B, n_tiles, 16]
                                int tc, int ratio, float dphi_scale) {
  extern __shared__ float buf[];
  float* gbuf = buf;                     // g, then d(phase) of VCO 1
  float* nbuf = buf + SEG_TILE * ratio;  // noise, then d(phase) of VCO 2
  __shared__ float red[N_SCALARS][WARPS];
  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n_tiles = gridDim.x, tcp = n_tiles * SEG_TILE;
  const int ta = tc * ratio;
  const int seg = tile * SEG_TILE + t;
  const int start = tile * SEG_TILE * ratio;
  const int len = min(SEG_TILE * ratio, ta - start);
  const float* grow = g + (size_t)b * ta + start;
  const float* nrow = noise + (size_t)b * ta + start;
  for (int i = t; i < len; i += SEG_TILE) {
    gbuf[i] = grow[i];
    nbuf[i] = nrow[i];
  }
  // d(phase) summed over all later tiles, from the last tile back
  float later[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float* tot = tile_total + ((size_t)b * 2 + o) * n_tiles;
    float c = 0.0f;
    for (int k = n_tiles - 1; k > tile; --k) c = c + tot[k];
    later[o] = c;
  }
  __syncthreads();

  float ds[N_SCALARS];
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i) ds[i] = 0.0f;
  float dw[5][3];  // per signal: d(prev), d(left), d(next)
#pragma unroll
  for (int s = 0; s < 5; ++s) dw[s][0] = dw[s][1] = dw[s][2] = 0.0f;

  if (seg < tc) {
    const Controls ctl = controls_at(routed, b, tc, seg);
    const float* sc = scalars + (size_t)b * 16;
    float mean[2], offset[2], acc[2] = {0.0f, 0.0f};
    load_segment_state(seg_mean, phase_offset, b, tcp, seg, mean, offset);
    float* g_seg = gbuf + t * ratio;
    float* n_seg = nbuf + t * ratio;

    // forward in time: phase recompute, oscillator, VCA and mixer cotangents
    for (int j = 0; j < ratio; ++j) {
      const float jw = interp_offset(j, ratio);
      const float w = fabsf(jw);
      const bool use_prev = jw < 0.0f;
      const float wl = 1.0f - w, wp = use_prev ? w : 0.0f, wn = use_prev ? 0.0f : w;
      const SampleGrads d = sample_grads(ctl, sc, mean, offset, acc, w, use_prev,
                                         (float)(j + 1), dphi_scale, g_seg[j], n_seg[j]);
      ds[2] = ds[2] + d.dp1;
      ds[5] = ds[5] + d.dp2;
      ds[6] = ds[6] + d.dshape;
      ds[7] = ds[7] + d.dpartials;
      ds[8] = ds[8] + d.dl1;
      ds[9] = ds[9] + d.dl2;
      ds[10] = ds[10] + d.dl3;
      const float du[3] = {d.du1, d.du3, d.du4};
      const int sig[3] = {1, 3, 4};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dw[sig[k]][0] = dw[sig[k]][0] + du[k] * wp;
        dw[sig[k]][1] = dw[sig[k]][1] + du[k] * wl;
        dw[sig[k]][2] = dw[sig[k]][2] + du[k] * wn;
      }
      g_seg[j] = d.dp1;
      n_seg[j] = d.dp2;
    }

    // backward in time: d(dphi) = suffix of d(phase), then the pitch chain
    float carry[2], suf[2] = {0.0f, 0.0f};
#pragma unroll
    for (int o = 0; o < 2; ++o) carry[o] = seg_suffix[((size_t)b * 2 + o) * tcp + seg] + later[o];
    for (int j = ratio - 1; j >= 0; --j) {
      const float jw = interp_offset(j, ratio);
      const float w = fabsf(jw);
      const bool use_prev = jw < 0.0f;
      const float wl = 1.0f - w, wp = use_prev ? w : 0.0f, wn = use_prev ? 0.0f : w;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float base = sc[3 * o], depth = sc[3 * o + 1];
        const float u = ctl.at(2 * o, w, use_prev);
        suf[o] = suf[o] + (o == 0 ? g_seg[j] : n_seg[j]);
        const float d_dphi = suf[o] + carry[o];
        const float pre = base + depth * u;
        const float dphi = phase_increment(u, base, depth, dphi_scale);
        const float mask = (pre > 0.0f && pre < 127.0f) ? 1.0f : 0.0f;
        const float d_midi = d_dphi * dphi * LN2_OVER_12 * mask;
        ds[3 * o] = ds[3 * o] + d_midi;
        ds[3 * o + 1] = ds[3 * o + 1] + d_midi * u;
        const float du = d_midi * depth;
        dw[2 * o][0] = dw[2 * o][0] + du * wp;
        dw[2 * o][1] = dw[2 * o][1] + du * wl;
        dw[2 * o][2] = dw[2 * o][2] + du * wn;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) d_seg[(((size_t)b * 5 + s) * 3 + c) * tcp + seg] = dw[s][c];

  // scalar cotangents: a shuffle tree in each warp, then the warp totals in order
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i) {
    float v = ds[i];
    for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(FULL, v, off);
    if (lane == 0) red[i][warp] = v;
  }
  __syncthreads();
  if (t < 16) {
    float v = 0.0f;
    if (t < N_SCALARS) {
      v = red[t][0];
      for (int w = 1; w < WARPS; ++w) v = v + red[t][w];
    }
    d_part[((size_t)b * n_tiles + tile) * 16 + t] = v;
  }
}

// Pass 3: d_scalars[b, i] = the tiles' partials added in tile order.
__global__ void bwd_fold_kernel(const float* __restrict__ d_part, float* __restrict__ d_scalars,
                                int batch, int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * 16) return;
  const int b = idx / 16, i = idx % 16;
  float v = 0.0f;
  for (int k = 0; k < n_tiles; ++k) v = v + d_part[((size_t)b * n_tiles + k) * 16 + i];
  d_scalars[idx] = v;
}

}  // namespace

// Launches the three passes on `stream`. Pointers are device pointers to contiguous
// float32 tensors: routed [B, 5, tc], scalars [B, 16], noise and g [B, tc*ratio],
// seg_mean and phase_offset [B, 2, tcp] as the forward saved them (tcp = n_tiles*64);
// scratch seg_suffix [B, 2, tcp], tile_total [B, 2, n_tiles], d_part [B, n_tiles, 16];
// outputs d_seg [B, 5, 3, tcp] and d_scalars [B, 16]. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int render_bwd_launch(const float* routed, const float* scalars, const float* noise,
                                 const float* g, const float* seg_mean, const float* phase_offset,
                                 float* seg_suffix, float* tile_total, float* d_seg, float* d_part,
                                 float* d_scalars, int batch, int tc, int ratio, float dphi_scale,
                                 void* stream) {
  if (batch <= 0 || tc <= 0 || ratio < 1 || ratio > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (tc + SEG_TILE - 1) / SEG_TILE;
  dim3 grid(n_tiles, batch);
  const size_t smem1 = (size_t)SEG_TILE * ratio * sizeof(float);
  bwd_seg_kernel<<<grid, SEG_TILE, smem1, s>>>(routed, scalars, g, seg_mean, phase_offset,
                                               seg_suffix, tile_total, tc, ratio, dphi_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = 2 * smem1;  // above the 48 KB default for ratio > 96
  err = cudaFuncSetAttribute(bwd_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  bwd_main_kernel<<<grid, SEG_TILE, smem2, s>>>(routed, scalars, noise, g, seg_mean, phase_offset,
                                                seg_suffix, tile_total, d_seg, d_part, tc, ratio,
                                                dphi_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  bwd_fold_kernel<<<(batch * 16 + threads - 1) / threads, threads, 0, s>>>(d_part, d_scalars,
                                                                          batch, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" int render_bwd_seg_tile() { return SEG_TILE; }
