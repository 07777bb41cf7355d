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
// the tally and the bound). As in the forward, --fmad=false halves the float32
// pipe's rate against the 67 TFLOP/s peak the bound divides by, so about 50% of
// the stated bound is the ceiling; tensor cores do not apply (float32 sums).
//
// What held the first design (three launches, one thread per segment) back, and
// what this one does about each:
//   1. The whole forward was recomputed twice (once only to sum d(phase) per
//      segment, once for the cotangents) and the backward walk evaluated the
//      phase increment a third time. Here one launch walks each sample forward
//      once; each sample's increment and its two d(phase) values wait in shared
//      memory (4 floats per sample, by thread) for the backward walk.
//   2. Occupancy: 51.2 KB of shared staging per 64-thread block and 103
//      registers, 8 warps per SM. Here g and noise are read straight into
//      registers by the thread that owns the samples, the controls are read from
//      the block's shared window at each use, and registers are sized for 3
//      blocks of 256 threads (24 warps) per SM (chip_smoke.py prints registers,
//      spills and resident blocks).
//   3. One thread walked a segment's 100 samples in series, twice, across three
//      launches. Here 8 lanes share a segment (render_common.cuh) and the
//      later-tile carry is chained in the one launch.
//
// Design.
//   - The phase is a prefix sum of dphi over the voice, so d(dphi)[u] is the
//     suffix sum of d(phase)[t] over t >= u: all 176,400 samples of a 4 s voice.
//     These sums are plain float32 sums (the mod-2pi wraps of the forward are
//     gradient-transparent), not wrapped.
//   - The forward phase is recomputed exactly, from the segment means and final
//     wrapped offsets the forward saved, with the forward's helpers and its
//     association of the residual prefix (a lane's running residual plus the
//     exclusive scan over the segment's lanes). A phase off by a rounding would
//     move sin and cos and so every cotangent.
//   - A chained suffix carry, in one launch: tickets map to (voice, tile) from the
//     last tile of each voice back to the first, so tile k is taken after tile
//     k+1. A block walks its tile forward (phase, oscillator, VCA and mixer
//     cotangents), sums d(phase) per lane, per segment (a suffix scan over the
//     lanes) and over the tile (a suffix scan over the segments), then one thread
//     waits for tile k+1's inclusive suffix, publishes incl[k] = incl[k+1] +
//     total[k] (the first design's fold c = c + tot[k] from the last tile back,
//     operation for operation), and the block walks back through the suffix and
//     the pitch chain. It waits only on a smaller ticket, so it cannot deadlock
//     (render_common.cuh).
//   - The scalar cotangents are summed without float atomics: per thread, a
//     shuffle tree per warp, the warp totals in order, one partial per tile; the
//     block that finishes a voice last (a per-voice counter) adds the tiles'
//     partials in tile order, so no third launch folds them. Runs repeat bit for
//     bit, and the plain version (ops/render.py:render_audio_bwd_plain) repeats
//     every sum in the same association.
//   - The masks are strict, as in the TPU kernel: the pitch clip passes gradient
//     only for 0 < pre < 127, a VCA only for u > 0.
//   - Padded segments (seg >= Tc in the last tile) have no samples and write zeros.
//     A slot without a sample reads g = 0, so its cotangents are +-0 and add
//     nothing; only the residual prefix and the pitch chain mask it.

#include "render_common.cuh"

namespace {

using namespace render;

constexpr int N_SCALARS = 11;  // used columns of the [B, 16] scalars

// The cotangents of one sample that do not need the phase suffix sum.
struct SampleGrads {
  float dp1, dp2;          // d/d(phase) of VCO 1 and VCO 2
  float du1, du3, du4;     // d/d(vco_1_amp, vco_2_amp, noise_amp) at this sample
  float dl1, dl2, dl3;     // d/d(mixer levels)
  float dshape, dpartials;
};

__device__ __forceinline__ SampleGrads sample_grads(const float* sc, float phase1, float phase2,
                                                    float u1, float u3, float u4, float g,
                                                    float nz) {
  SampleGrads r;
  // VCO 1: sine
  float s1, c1;
  sincos_fast(phase1 + sc[2], &s1, &c1);
  const float a1 = fmaxf(u1, 0.0f);
  const float gl1 = g * sc[8];
  r.dl1 = (g * c1) * a1;
  r.du1 = (gl1 * c1) * (u1 > 0.0f ? 1.0f : 0.0f);
  r.dp1 = -(gl1 * a1) * s1;
  // VCO 2: square <-> saw morph
  float s2, c2;
  sincos_fast(phase2 + sc[5], &s2, &c2);
  const float shape = sc[6], partials = sc[7];
  // PI_F * partials * s2 / 2 as (PI_F * partials / 2) * s2: halving is exact
  const float sq = tanh_fast(PI_F * partials / 2.0f * s2);
  const float amod = 1.0f - shape / 2.0f;
  const float bmod = 1.0f + shape * c2;
  const float osc2 = amod * sq * bmod;
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
  r.dl3 = (g * nz) * fmaxf(u4, 0.0f);
  r.du4 = (g * sc[10] * nz) * (u4 > 0.0f ? 1.0f : 0.0f);
  return r;
}

template <int RUN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
render_bwd_kernel(const float* __restrict__ routed,        // [B, 5, tc]
                  const float* __restrict__ scalars,       // [B, 16]
                  const float* __restrict__ noise,         // [B, ta]
                  const float* __restrict__ g,             // [B, ta]
                  const float* __restrict__ seg_mean,      // [B, 2, tcp]
                  const float* __restrict__ phase_offset,  // [B, 2, tcp]
                  float* __restrict__ d_seg,               // [B, 5, 3, tcp]
                  float* __restrict__ d_part,              // [B, n_tiles, 16]
                  float* __restrict__ d_scalars,           // [B, 16]
                  unsigned long long* __restrict__ sync,
                  int batch, int tc, int ratio, float dphi_scale) {
  __shared__ Window win;
  __shared__ float seg_tot[2][SEG_TILE];
  __shared__ float seg_carry[2][SEG_TILE];
  __shared__ float red[N_SCALARS][WARPS];
  // each sample's increments and d(phase) for both oscillators, by thread
  extern __shared__ float slots[];  // [2 (dphi, dph)][2][RUN][THREADS]
  __shared__ bool last_block;
  __shared__ int ticket_s;
  const int n_tiles = (tc + SEG_TILE - 1) / SEG_TILE, tcp = n_tiles * SEG_TILE;
  const int t = threadIdx.x;
  if (t == 0) ticket_s = take_ticket(sync);
  set_offsets(win, ratio);
  __syncthreads();
  const int ticket = ticket_s;
  const int rt = ticket / batch, b = ticket - rt * batch;
  const int tile = n_tiles - 1 - rt;  // from the last tile of a voice back to the first
  const int ta = tc * ratio;
  unsigned long long* status = sync + 1 + (size_t)b * n_tiles + tile;
  const unsigned long long seen = t == 0 && tile < n_tiles - 1 ? peek(status + 1) : UNPUBLISHED;
  if (t < WINDOW) (&win.ctl[0][0])[t] = window_value(routed, b, tc, tile, t);
  const Lane ln = lane_of<RUN>();
  const int seg = tile * SEG_TILE + ln.s;
  const bool valid = seg < tc;  // padded segments have no samples
  const int n = valid ? min(max(ratio - ln.j0, 0), RUN) : 0;  // slots that hold a sample
  const float* sc = scalars + (size_t)b * 16;
  const size_t base_idx = (size_t)b * ta + (size_t)seg * ratio + ln.j0;
  const float* grow = g + base_idx;  // this thread's run
  const float* nrow = noise + base_idx;
  float mean[2], offset[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const size_t i = ((size_t)b * 2 + o) * tcp + seg;
    mean[o] = seg_mean[i];
    offset[o] = phase_offset[i];
  }
  __syncthreads();
  const WindowControls ctl = {&win, ln.s};
  auto dphi = [&](int o, int i) -> float& { return slots[(o * RUN + i) * THREADS + t]; };
  auto dph = [&](int o, int i) -> float& { return slots[((2 + o) * RUN + i) * THREADS + t]; };

  // increments, once per sample, and the exclusive residual prefix of the lane
  float res[2] = {0.0f, 0.0f}, ex[2];
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const Weights wt = weights_at(win, ln.j0 + i);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float d = phase_increment(upsample(ctl, 2 * o, wt), sc[3 * o], sc[3 * o + 1], dphi_scale);
      dphi(o, i) = d;
      res[o] = res[o] + (i < n ? d - mean[o] : 0.0f);
    }
  }
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    ex[o] = segment_exclusive_scan(res[o], ln.k);
    res[o] = 0.0f;
  }

  float ds[N_SCALARS];
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i) ds[i] = 0.0f;
  float dw[5][3];  // per signal: d(prev), d(left), d(next)
#pragma unroll
  for (int s = 0; s < 5; ++s) dw[s][0] = dw[s][1] = dw[s][2] = 0.0f;

  // forward in time: phase recompute, oscillator, VCA and mixer cotangents. A slot
  // without a sample reads g = 0, so each of its cotangents is +-0 and adds nothing.
  float ramp = (float)(ln.j0 + 1);
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const bool ok = i < n;
    const Weights wt = weights_at(win, ln.j0 + i);
    const float wp = wt.use_prev ? wt.w : 0.0f, wn = wt.use_prev ? 0.0f : wt.w;
    float phase[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      res[o] = res[o] + (ok ? dphi(o, i) - mean[o] : 0.0f);
      phase[o] = (mean[o] * ramp + (ex[o] + res[o])) + offset[o];
    }
    ramp = ramp + 1.0f;
    const float gi = ok ? __ldg(grow + i) : 0.0f;
    const float ni = ok ? __ldg(nrow + i) : 0.0f;
    const SampleGrads d = sample_grads(sc, phase[0], phase[1], upsample(ctl, 1, wt),
                                       upsample(ctl, 3, wt), upsample(ctl, 4, wt), gi, ni);
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
    for (int c = 0; c < 3; ++c) {
      dw[sig[c]][0] = dw[sig[c]][0] + du[c] * wp;
      dw[sig[c]][1] = dw[sig[c]][1] + du[c] * wt.wl;
      dw[sig[c]][2] = dw[sig[c]][2] + du[c] * wn;
    }
    dph(0, i) = d.dp1;
    dph(1, i) = d.dp2;
  }

  // d(phase) summed over the lane's run (from its end), the later lanes of the
  // segment, the later segments of the tile and the later tiles
  float lane_later[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    float q = 0.0f;
#pragma unroll
    for (int i = RUN - 1; i >= 0; --i) q = q + dph(o, i);
    float seg_total;
    lane_later[o] = segment_exclusive_suffix(q, ln.k, &seg_total);
    if (ln.k == 0) seg_tot[o][ln.s] = seg_total;
  }
  __syncthreads();
  if (t < 32) {
    float excl[2], tile_total[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float incl = tile_inclusive_suffix(t < SEG_TILE ? seg_tot[o][t] : 0.0f, t);
      const float dn = __shfl_down_sync(FULL, incl, 1, SEG_TILE);
      excl[o] = t == SEG_TILE - 1 ? 0.0f : dn;
      tile_total[o] = __shfl_sync(FULL, incl, 0);
    }
    float later[2] = {0.0f, 0.0f};
    if (t == 0) {
      if (tile < n_tiles - 1) wait_for(status + 1, seen, &later[0], &later[1]);
      publish(status, later[0] + tile_total[0], later[1] + tile_total[1]);
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      later[o] = __shfl_sync(FULL, later[o], 0);
      if (t < SEG_TILE) seg_carry[o][t] = excl[o] + later[o];
    }
  }
  __syncthreads();

  // backward in time: d(dphi) = suffix of d(phase), then the pitch chain
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float carry = lane_later[o] + seg_carry[o][ln.s];
    const float base = sc[3 * o], depth = sc[3 * o + 1];
    float q = 0.0f;
#pragma unroll
    for (int i = RUN - 1; i >= 0; --i) {
      const Weights wt = weights_at(win, ln.j0 + i);
      const float wp = wt.use_prev ? wt.w : 0.0f, wn = wt.use_prev ? 0.0f : wt.w;
      const float u = upsample(ctl, 2 * o, wt);
      q = q + dph(o, i);
      const float d_dphi = q + carry;
      const float pre = base + depth * u;
      const float mask = (i < n && pre > 0.0f && pre < 127.0f) ? 1.0f : 0.0f;
      const float d_midi = d_dphi * dphi(o, i) * LN2_OVER_12 * mask;
      ds[3 * o] = ds[3 * o] + d_midi;
      ds[3 * o + 1] = ds[3 * o + 1] + d_midi * u;
      const float du = d_midi * depth;
      dw[2 * o][0] = dw[2 * o][0] + du * wp;
      dw[2 * o][1] = dw[2 * o][1] + du * wt.wl;
      dw[2 * o][2] = dw[2 * o][2] + du * wn;
    }
  }

  // per segment: the lanes' upsample cotangents, by the butterfly
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = segment_sum(dw[s][c]);
      if (ln.k == 0) d_seg[(((size_t)b * 5 + s) * 3 + c) * tcp + seg] = v;
    }

  // scalar cotangents: a shuffle tree in each warp, the warp totals in order
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int i = 0; i < N_SCALARS; ++i) {
    float v = ds[i];
#pragma unroll
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
    __threadfence();
  }
  __syncthreads();
  // the voice's last block to finish adds the tiles' partials in tile order
  if (t == 0) {
    unsigned long long* done = sync + 1 + (size_t)batch * n_tiles + b;
    last_block = atomicAdd(done, 1ull) + 1ull == (unsigned long long)(n_tiles - 1);
  }
  __syncthreads();
  if (last_block && t < 16) {
    __threadfence();
    float v = 0.0f;
    for (int k = 0; k < n_tiles; ++k) v = v + __ldcg(d_part + ((size_t)b * n_tiles + k) * 16 + t);
    d_scalars[(size_t)b * 16 + t] = v;
  }
}

// Dynamic shared memory of a block: each thread's increments and d(phase).
constexpr size_t slot_bytes(int run) { return (size_t)4 * run * THREADS * sizeof(float); }

}  // namespace

// One launch on `stream`. Pointers are device pointers to contiguous float32
// tensors: routed [B, 5, tc], scalars [B, 16], noise and g [B, tc*ratio],
// seg_mean and phase_offset [B, 2, tcp] as the forward saved them (tcp = n_tiles *
// SEG_TILE); scratch d_part [B, n_tiles, 16]; outputs d_seg [B, 5, 3, tcp] and
// d_scalars [B, 16]; `sync` is 1 + B*n_tiles + B 64-bit words of all
// ones. Returns the cudaError_t of the launch (0 on success).
extern "C" int render_bwd_launch(const float* routed, const float* scalars, const float* noise,
                                 const float* g, const float* seg_mean, const float* phase_offset,
                                 float* d_seg, float* d_part, float* d_scalars, void* sync,
                                 int batch, int tc, int ratio, float dphi_scale, void* stream) {
  if (batch <= 0 || tc <= 0 || ratio < 1 || ratio > LANES * MAX_RUN)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (tc + SEG_TILE - 1) / SEG_TILE;
  auto* s = (unsigned long long*)sync;
  auto* st = (cudaStream_t)stream;
  return dispatch_run<1>(run_for(ratio), [&](auto run) {
    constexpr int RUN = decltype(run)::value;
    const size_t smem = slot_bytes(RUN);
    cudaError_t err = cudaFuncSetAttribute(render_bwd_kernel<RUN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    render_bwd_kernel<RUN><<<n_tiles * batch, THREADS, smem, st>>>(
        routed, scalars, noise, g, seg_mean, phase_offset, d_seg, d_part, d_scalars, s, batch, tc,
        ratio, dphi_scale);
    return (int)cudaGetLastError();
  });
}

extern "C" int render_bwd_seg_tile() { return SEG_TILE; }

// Resident blocks per SM at this kernel's registers and shared memory, for the
// 4 s voices' ratio 100.
extern "C" int render_bwd_occupancy() {
  int blocks = 0;
  constexpr int RUN = run_for(100);
  if (cudaFuncSetAttribute(render_bwd_kernel<RUN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)slot_bytes(RUN)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, render_bwd_kernel<RUN>, THREADS,
                                                    slot_bytes(RUN)) != cudaSuccess)
    return -1;
  return blocks;
}
