// Forward audio-rate render of the Voice synthesizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel inverse_audio_synthesis_tpu/ops/pallas/render.py:_kernel
// (launched by render_audio_fused). It computes the same function: half-pixel
// linear upsampling of the 5 routed controls to audio rate, MIDI pitch
// modulation clipped to [0, 127], exp2 to a phase increment, 2pi-wrapped phase
// integration, the sine VCO, the square/saw VCO, relu VCAs and the 3-way mix
// with the noise buffer.
//
// What bounds it on an H100: one read of the noise buffer and one write of the
// audio (8 bytes per sample) against ~180 float32 operations per sample, so the
// operations bound it (chip_smoke.py keeps the tally and the bound). The bound
// divides by 67 TFLOP/s, a peak that counts an FMA as two operations; this
// kernel may not contract a*b+c (--fmad=false), so its multiplies and adds
// retire at most at half that rate: about 50% of the stated bound is its ceiling.
// Tensor cores do not apply: the prefix sums need float32 (the TPU kernel split
// its MXU dots in three to stay exact, ops/pallas/render.py:_dot_f32_split), and
// TF32 would drift the phase. The float32 pipe and the instructions around it
// are the levers: the kernel's SASS holds about 1.7 instructions for each
// float32 multiply or add of that unfused math (chip_smoke.py prints both
// counts), and its time does not move with occupancy (3 to 6 blocks per SM
// measured alike), so instruction issue bounds it.
//
// What held the first design (two launches, one thread per segment) back, and
// what this one does about each:
//   1. Each phase increment was evaluated three times (segment sum, residual
//      prefix, render), with an IEEE division in the interpolation offset at every
//      sample and about 12 IEEE divisions per sample in all. Here each increment
//      is evaluated once: a thread keeps the increments of its run in registers,
//      and the segment's sum (so its mean) and the residual prefix come from
//      width-8 warp shuffles over the lanes of the segment (render_common.cuh).
//      The offsets jw are divided once per block; the pitch's x / 12 and tanh's
//      quotient take short FMA sequences equal to IEEE division on their domains
//      (checked on every float of them, render_common.cuh:div12), floor and the
//      float-to-int conversion take the float32 pipe (floor_small).
//   2. Occupancy: 64-thread blocks with 25.6 KB of shared staging for noise and
//      audio, 16 warps per SM. Here a block has 256 threads and ~3 KB of shared
//      memory, registers are sized for 3 blocks (24 warps) per SM, and each thread
//      reads its own consecutive noise samples and writes its audio directly
//      (neighbouring lanes own neighbouring runs), with no staging.
//   3. One thread walked 100 samples in series, reading 5 controls from global
//      memory at every sample. Here 8 lanes share a segment (runs of 13 samples),
//      and the tile's 5 x (SEG_TILE + 2) controls are read once into shared
//      memory, then into each lane's registers.
//   4. Every thread folded the carry of up to 27 earlier tiles with fmodf, a
//      software loop. Here one thread folds once (the chained tile carry below),
//      the segments' wraps run in warp 0 only, and mod_2pi is one exact FMA.
//
// The chained tile carry (one launch, persistent blocks). As many blocks as fit
// on the card at once loop over tiles; each takes tiles by tickets from an
// atomic counter, tile-major, so tile k of a voice is always taken after tile
// k-1. For each tile a block computes the increments, means, segment totals and
// wrapped tile total; then one thread waits for tile k-1's wrapped inclusive
// prefix (one 64-bit word holding both oscillators' values, published with a
// release store and awaited with acquire loads; it was read once when the tile
// began, so at large batch it has usually arrived), forms incl[k] =
// mod_2pi(incl[k-1] + total[k]), publishes it and the block renders. While it
// works on a tile the block already holds the ticket of its next one, and reads
// that tile's controls during the render into its second window: the ticket's
// and the controls' latency, which each tile's block paid at its start, are
// hidden. Why the chain cannot deadlock is written in render_common.cuh.
// incl[k] = mod_2pi(incl[k-1] + total[k]) from incl[-1] = 0 is the first
// design's carry fold c = mod_2pi(c + tot[k]) operation for operation, so runs
// repeat bit for bit (a look-back over aggregates would reassociate it).
//
// Association of the phase inside a segment (the TPU kernel's mean plus residual
// prefix, ops/pallas/render.py:113-119): the mean is the segment's sum (each lane
// sums its run in order, then the butterfly over lanes) over the ratio; the
// residual prefix at sample j is the exclusive scan of the lanes' residual totals
// plus the lane's own running residual; phase = (mean * (j + 1) + prefix) +
// offset. A segment's total is mod_2pi(mean * ratio + prefix at its last sample);
// the tile's segment offsets are a warp scan of those totals. On request the
// kernel writes each segment's mean and final wrapped offset (carry folded in),
// from which the backward (render_bwd.cu) rebuilds every sample's phase exactly.
//
// Rounding. Every step is an exactly rounded float32 mul/add/div/floor/fmod, in
// the order of the plain version (ops/render.py:render_audio_plain) and of
// ops/math_ops.py, with the helpers of render_common.cuh. Build with --fmad=false.

#include "render_common.cuh"

namespace {

using namespace render;

template <int RUN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
render_kernel(const float* __restrict__ routed,   // [B, 5, tc]
              const float* __restrict__ scalars,  // [B, 16]
              const float* __restrict__ noise,    // [B, ta]
              float* __restrict__ out,            // [B, ta]
              float* __restrict__ seg_mean,       // [B, 2, tcp] or null
              float* __restrict__ phase_offset,   // [B, 2, tcp] or null
              unsigned long long* __restrict__ sync,
              int batch, int tc, int ratio, float dphi_scale) {
  __shared__ Window wins[2];  // this tile's window and the next one's
  __shared__ float seg_tot[2][SEG_TILE];  // unwrapped segment totals
  __shared__ float seg_off[2][SEG_TILE];
  __shared__ int tickets[2];  // the block's first ticket, then each next one
  const int n_tiles = (tc + SEG_TILE - 1) / SEG_TILE, tcp = n_tiles * SEG_TILE;
  const int total = n_tiles * batch, ta = tc * ratio, t = threadIdx.x;
  const Lane ln = lane_of<RUN>();
  const int n = min(max(ratio - ln.j0, 0), RUN);  // slots of the run that hold a sample
  set_offsets(wins[0], ratio);
  set_offsets(wins[1], ratio);
  if (t == 0) tickets[0] = take_ticket(sync);
  __syncthreads();
  int ticket = tickets[0], cur = 0;
  if (ticket < total && t < WINDOW)
    (&wins[0].ctl[0][0])[t] = window_value(routed, ticket % batch, tc, ticket / batch, t);
  __syncthreads();

  while (ticket < total) {
    const Window& win = wins[cur];
    const int tile = ticket / batch, b = ticket - tile * batch;
    unsigned long long* status = sync + 1 + (size_t)b * n_tiles + tile;
    unsigned long long seen = UNPUBLISHED;
    int next = 0;
    if (t == 0) {  // both reads are in flight while the tile's increments run
      next = take_ticket(sync);
      if (tile > 0) seen = peek(status - 1);
    }
    const int seg = tile * SEG_TILE + ln.s;
    const bool valid = seg < tc;
    const float* sc = scalars + (size_t)b * 16;
    const size_t base_idx = (size_t)b * ta + (size_t)seg * ratio + ln.j0;
    const float* nrow = noise + base_idx;  // this thread's run
    float* orow = out + base_idx;
    const SegControls ctl = seg_controls(win, ln.s);

    // increments, once per sample; then the segment's mean and residual prefix
    float acc[2][RUN], run_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
      const Weights wt = weights_at(win, ln.j0 + i);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float d = phase_increment(upsample(ctl, 2 * o, wt), sc[3 * o], sc[3 * o + 1],
                                        dphi_scale);
        acc[o][i] = d;
        run_sum[o] = run_sum[o] + (i < n ? d : 0.0f);
      }
    }
    float mean[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float m = segment_sum(run_sum[o]) / (float)ratio;
      float res = 0.0f;
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        res = res + (i < n ? acc[o][i] - m : 0.0f);
        acc[o][i] = res;  // the lane's running residual, for now
      }
      const float ex = segment_exclusive_scan(res, ln.k);
#pragma unroll
      for (int i = 0; i < RUN; ++i) acc[o][i] = ex + acc[o][i];
      // the segment's unwrapped total, from the lane of its last sample
      const float last = __shfl_sync(FULL, ex + res, (ratio - 1) / RUN, LANES);
      if (ln.k == 0) seg_tot[o][ln.s] = m * (float)ratio + last;
      mean[o] = m;
    }
    __syncthreads();

    // warp 0: the segments' wrapped totals, the tile's segment offsets, then the
    // chained carry from tile k-1
    if (t < 32) {
      float excl[2], tile_total[2];
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float incl = tile_inclusive_scan(t < SEG_TILE ? mod_2pi(seg_tot[o][t]) : 0.0f, t);
        const float ex = __shfl_up_sync(FULL, incl, 1);
        excl[o] = mod_2pi(t == 0 ? 0.0f : ex);  // the segment's wrapped offset in its tile
        tile_total[o] = mod_2pi(__shfl_sync(FULL, incl, SEG_TILE - 1));
      }
      float carry[2] = {0.0f, 0.0f};
      if (t == 0) {
        if (tile > 0) wait_for(status - 1, seen, &carry[0], &carry[1]);
        publish(status, mod_2pi(carry[0] + tile_total[0]), mod_2pi(carry[1] + tile_total[1]));
        tickets[1] = next;
      }
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        carry[o] = __shfl_sync(FULL, carry[o], 0);
        if (t < SEG_TILE) seg_off[o][t] = mod_2pi(excl[o] + carry[o]);
      }
    }
    __syncthreads();
    const float offset[2] = {seg_off[0][ln.s], seg_off[1][ln.s]};
    if (ln.k == 0) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const size_t i = ((size_t)b * 2 + o) * tcp + seg;
        if (seg_mean != nullptr) seg_mean[i] = mean[o];
        if (phase_offset != nullptr) phase_offset[i] = offset[o];
      }
    }
    // the next tile's window value, read while this tile renders and stored in the
    // other window after it
    const int next_ticket = tickets[1];
    float next_ctl = 0.0f;
    if (next_ticket < total && t < WINDOW)
      next_ctl = window_value(routed, next_ticket % batch, tc, next_ticket / batch, t);

    if (valid) {
      const float phase0_1 = sc[2], phase0_2 = sc[5], shape = sc[6], partials = sc[7];
      const float level1 = sc[8], level2 = sc[9], level3 = sc[10];
      // PI_F * partials * s2 / 2 as (PI_F * partials / 2) * s2: halving is exact,
      // so both round the same product
      const float half_arg = PI_F * partials / 2.0f;
      float ramp = (float)(ln.j0 + 1);
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        const int j = ln.j0 + i;
        const Weights wt = weights_at(win, j);
        const float phase1 = (mean[0] * ramp + acc[0][i]) + offset[0];
        const float phase2 = (mean[1] * ramp + acc[1][i]) + offset[1];
        ramp = ramp + 1.0f;
        // VCO 1: sine
        float s1, c1;
        sincos_fast(phase1 + phase0_1, &s1, &c1);
        float mix = level1 * c1 * fmaxf(upsample(ctl, 1, wt), 0.0f);
        // VCO 2: square <-> saw morph
        float s2, c2;
        sincos_fast(phase2 + phase0_2, &s2, &c2);
        const float square = tanh_fast(half_arg * s2);
        const float osc2 = (1.0f - shape / 2.0f) * square * (1.0f + shape * c2);
        mix = mix + level2 * osc2 * fmaxf(upsample(ctl, 3, wt), 0.0f);
        // noise
        const float nz = i < n ? __ldg(nrow + i) : 0.0f;
        mix = mix + level3 * nz * fmaxf(upsample(ctl, 4, wt), 0.0f);
        if (i < n) orow[i] = mix;
      }
    }
    if (next_ticket < total && t < WINDOW) (&wins[cur ^ 1].ctl[0][0])[t] = next_ctl;
    __syncthreads();  // the next window is in place; this one, the offsets and the tickets are free
    ticket = next_ticket;
    cur ^= 1;
  }
}

template <int RUN>
int launch(const float* routed, const float* scalars, const float* noise, float* out,
           float* seg_mean, float* phase_offset, unsigned long long* sync, int batch, int tc,
           int ratio, float dphi_scale, cudaStream_t stream) {
  const int n_tiles = (tc + SEG_TILE - 1) / SEG_TILE;
  int blocks = 0;
  const int err = persistent_blocks(render_kernel<RUN>, 0, n_tiles * batch, &blocks);
  if (err != 0) return err;
  render_kernel<RUN><<<blocks, THREADS, 0, stream>>>(routed, scalars, noise, out, seg_mean,
                                                      phase_offset, sync, batch, tc, ratio,
                                                      dphi_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`. Pointers are device pointers to contiguous float32
// tensors: routed [B, 5, tc], scalars [B, 16], noise and out [B, tc*ratio],
// seg_mean and phase_offset [B, 2, tcp] (tcp = n_tiles * SEG_TILE) or null (then
// not written); `sync` is 1 + B*n_tiles 64-bit words of all ones. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int render_fwd_launch(const float* routed, const float* scalars, const float* noise,
                                 float* out, float* seg_mean, float* phase_offset, void* sync,
                                 int batch, int tc, int ratio, float dphi_scale, void* stream) {
  if (batch <= 0 || tc <= 0 || ratio < 1 || ratio > LANES * MAX_RUN)
    return (int)cudaErrorInvalidValue;
  auto* s = (unsigned long long*)sync;
  auto* st = (cudaStream_t)stream;
  return dispatch_run<1>(run_for(ratio), [&](auto run) {
    return launch<decltype(run)::value>(routed, scalars, noise, out, seg_mean, phase_offset, s,
                                        batch, tc, ratio, dphi_scale, st);
  });
}

extern "C" int render_fwd_seg_tile() { return SEG_TILE; }

// Resident blocks per SM at this kernel's registers and shared memory, for the
// 4 s voices' ratio 100.
extern "C" int render_fwd_occupancy() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, render_kernel<run_for(100)>, THREADS,
                                                    0) != cudaSuccess)
    return -1;
  return blocks;
}

// The exhaustive check of render_common.cuh's division, remainder and floor sequences,
// bit for bit on every float of the domain each is used on: div12 against
// div.rn.f32 for x = +0 and 2^-18 <= |x| <= 128 (the pitch's midi - 69 is exact
// for midi >= 34.5, so it is +0 or a multiple of ulp(32) = 2^-18, and above 34.5
// in magnitude otherwise); div_rn(y - 1, y + 1) against div.rn.f32 for y in
// [2^-125, 2^125] (tanh's exp2 stays within 2^+-124.1); mod_2pi against fmodf
// for x = -0 and 0 <= x < 2^20; floor_small against floorf and its integer for
// every y with |y| < 2^22 but -0. Adds the mismatches to counts[0..3].
__global__ void check_sequences_kernel(unsigned long long* counts) {
  const unsigned lo12 = 0x36800000u, hi12 = 0x43000000u;  // [2^-18, 128]
  const unsigned loy = 0x01000000u, hiy = 0x7e000000u;    // [2^-125, 2^125]
  const unsigned himod = 0x49800000u;                     // [+0, 2^20)
  const unsigned hifloor = 0x4a800000u;                   // [+0, 2^22)
  unsigned long long bad[4] = {0, 0, 0, 0};
  const unsigned step = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i <= hiy - loy; i += step) {
    if (i <= hi12 - lo12 + 1) {
      for (int sign = 0; sign < 2; ++sign) {
        // i = 0 stands for x = +0 (once), i >= 1 for |x| = lo12 + i - 1
        if (i == 0 && sign) continue;
        const float x = i == 0 ? 0.0f : __uint_as_float((lo12 + i - 1) | (sign ? 0x80000000u : 0u));
        bad[0] += __float_as_uint(render::div12(x)) != __float_as_uint(__fdiv_rn(x, 12.0f));
      }
    }
    const float y = __uint_as_float(loy + i);
    const float a = y - 1.0f, b = y + 1.0f;
    bad[1] += __float_as_uint(render::div_rn(a, b)) != __float_as_uint(__fdiv_rn(a, b));
    if (i <= himod) {
      const float x = i < himod ? __uint_as_float(i) : -0.0f;
      float r = fmodf(x, render::TWO_PI);
      r = (r != 0.0f && r < 0.0f) ? r + render::TWO_PI : r;
      bad[2] += __float_as_uint(render::mod_2pi(x)) != __float_as_uint(r);
    }
    if (i < hifloor) {
      for (int sign = 0; sign < 2; ++sign) {
        if (i == 0 && sign) continue;
        const float y = __uint_as_float(i | (sign ? 0x80000000u : 0u));
        int n;
        const float f = render::floor_small(y, &n);
        bad[3] += __float_as_uint(f) != __float_as_uint(floorf(y)) || n != (int)floorf(y);
      }
    }
  }
  for (int k = 0; k < 4; ++k)
    if (bad[k]) atomicAdd(&counts[k], bad[k]);
}

// Runs check_sequences_kernel and writes its four mismatch counts (div12, the
// tanh quotient, mod_2pi, floor_small) to `out`; returns 0, or -1 on a CUDA error.
extern "C" int render_fwd_check_sequences(long long* out) {
  unsigned long long* counts = nullptr;
  if (cudaMalloc(&counts, 4 * sizeof(unsigned long long)) != cudaSuccess) return -1;
  cudaMemset(counts, 0, 4 * sizeof(unsigned long long));
  check_sequences_kernel<<<132 * 8, 256>>>(counts);
  unsigned long long host[4] = {0, 0, 0, 0};
  const cudaError_t err = cudaMemcpy(host, counts, sizeof(host), cudaMemcpyDeviceToHost);
  cudaFree(counts);
  if (err != cudaSuccess || cudaGetLastError() != cudaSuccess) return -1;
  for (int k = 0; k < 4; ++k) out[k] = (long long)host[k];
  return 0;
}
