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
// audio (8 bytes per sample) against ~180 float32 operations per sample, so at
// 3.35 TB/s and 67 TFLOP/s both bounds sit near 7 us at batch 16 (PERF.md).
//
// Design. The phase is a prefix sum over 176,400 samples. It is cut into
// segments of `ratio` samples (one control-rate step each), tiles of SEG_TILE
// segments, and the voice:
//   - one thread owns one segment and accumulates dphi and the within-segment
//     prefix in registers (mean + residual prefix, the JAX kernel's
//     association);
//   - a block-wide scan of the segments' wrapped totals gives each segment's
//     offset inside its tile;
//   - a running carry, wrapped mod 2pi, crosses tiles.
// Blocks cannot hand a carry to each other in order, so the work is split in two
// launches on one stream: render_seg_kernel writes per-segment means and
// offsets and per-tile wrapped sums (a few hundred KB); render_audio_kernel
// folds the carry of all earlier tiles (at most a few dozen adds), then renders
// its tile. Noise is loaded and audio stored through shared memory, so that both
// are coalesced although each thread walks its own segment. On request the render
// pass also writes each segment's final wrapped phase offset (carry of the
// earlier tiles folded in); with the segment means they let the backward
// (render_bwd.cu) recompute every sample's phase exactly.
//
// Rounding. Every step is an exactly rounded float32 mul/add/div/floor/fmod, in
// the order of the plain version (ops/render.py:render_audio_plain) and of
// ops/math_ops.py, with the helpers of render_common.cuh. Build with --fmad=false.

#include "render_common.cuh"

namespace {

using namespace render;

// Pass 1: per segment, the mean phase increment and the wrapped offset inside its
// tile; per tile, its wrapped total. Grid (n_tiles, B), block SEG_TILE.
__global__ void render_seg_kernel(const float* __restrict__ routed,
                                  const float* __restrict__ scalars,
                                  float* __restrict__ seg_mean,    // [B, 2, tcp]
                                  float* __restrict__ seg_offset,  // [B, 2, tcp]
                                  float* __restrict__ tile_total,  // [B, 2, n_tiles]
                                  int tc, int ratio, float dphi_scale) {
  __shared__ float warp_tot[2][WARPS];
  __shared__ float incl_s[2][SEG_TILE];
  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n_tiles = gridDim.x, tcp = n_tiles * SEG_TILE;
  const int seg = tile * SEG_TILE + t;
  const Controls ctl = controls_at(routed, b, tc, seg);
  const float* sc = scalars + (size_t)b * 16;

  float total[2], mean[2];
  for (int o = 0; o < 2; ++o) {
    const int sig = 2 * o;  // vco_1_pitch, vco_2_pitch
    const float base = sc[3 * o], depth = sc[3 * o + 1];
    float sum = 0.0f;
    for (int j = 0; j < ratio; ++j) {
      float jw = interp_offset(j, ratio);
      sum = sum + phase_increment(ctl.at(sig, fabsf(jw), jw < 0.0f), base, depth, dphi_scale);
    }
    float m = sum / (float)ratio;
    float acc = 0.0f;
    for (int j = 0; j < ratio; ++j) {
      float jw = interp_offset(j, ratio);
      float d = phase_increment(ctl.at(sig, fabsf(jw), jw < 0.0f), base, depth, dphi_scale);
      acc = acc + (d - m);
    }
    mean[o] = m;
    total[o] = mod_2pi(m * (float)ratio + acc);
  }
  for (int o = 0; o < 2; ++o) {
    float incl = block_inclusive_scan(total[o], warp_tot[o]);
    incl_s[o][t] = incl;
  }
  __syncthreads();
  for (int o = 0; o < 2; ++o) {
    float excl = t > 0 ? incl_s[o][t - 1] : 0.0f;
    size_t i = ((size_t)b * 2 + o) * tcp + seg;
    seg_mean[i] = mean[o];
    seg_offset[i] = mod_2pi(excl);
    if (t == SEG_TILE - 1) tile_total[((size_t)b * 2 + o) * n_tiles + tile] = mod_2pi(incl_s[o][t]);
  }
}

// Pass 2: render one tile of one voice. Grid (n_tiles, B), block SEG_TILE,
// dynamic shared memory SEG_TILE * ratio floats.
__global__ void render_audio_kernel(const float* __restrict__ routed,
                                    const float* __restrict__ scalars,
                                    const float* __restrict__ noise,  // [B, ta]
                                    const float* __restrict__ seg_mean,
                                    const float* __restrict__ seg_offset,
                                    const float* __restrict__ tile_total,
                                    float* __restrict__ out,           // [B, ta]
                                    float* __restrict__ phase_offset,  // [B, 2, tcp] or null
                                    int tc, int ratio, float dphi_scale) {
  extern __shared__ float buf[];  // this tile's noise, overwritten by its audio
  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n_tiles = gridDim.x, tcp = n_tiles * SEG_TILE;
  const int ta = tc * ratio;
  const int seg = tile * SEG_TILE + t;
  const int start = tile * SEG_TILE * ratio;
  const int len = min(SEG_TILE * ratio, ta - start);
  const float* nrow = noise + (size_t)b * ta + start;
  for (int i = t; i < len; i += SEG_TILE) buf[i] = nrow[i];

  // carry into this tile: the wrapped totals of all earlier tiles, in order
  float carry[2];
  for (int o = 0; o < 2; ++o) {
    const float* tot = tile_total + ((size_t)b * 2 + o) * n_tiles;
    float c = 0.0f;
    for (int k = 0; k < tile; ++k) c = mod_2pi(c + tot[k]);
    carry[o] = c;
  }
  __syncthreads();

  float mean[2], offset[2];
  for (int o = 0; o < 2; ++o) {
    size_t i = ((size_t)b * 2 + o) * tcp + seg;
    mean[o] = seg_mean[i];
    offset[o] = mod_2pi(seg_offset[i] + carry[o]);
    if (phase_offset != nullptr) phase_offset[i] = offset[o];
  }
  if (seg < tc) {
    const Controls ctl = controls_at(routed, b, tc, seg);
    const float* sc = scalars + (size_t)b * 16;
    float acc[2] = {0.0f, 0.0f};
    const float phase0_1 = sc[2], phase0_2 = sc[5], shape = sc[6], partials = sc[7];
    const float level1 = sc[8], level2 = sc[9], level3 = sc[10];
    float* seg_buf = buf + t * ratio;
    for (int j = 0; j < ratio; ++j) {
      const float jw = interp_offset(j, ratio);
      const float w = fabsf(jw);
      const bool use_prev = jw < 0.0f;
      const float ramp = (float)(j + 1);
      float phase[2];
      for (int o = 0; o < 2; ++o) {
        float d = phase_increment(ctl.at(2 * o, w, use_prev), sc[3 * o], sc[3 * o + 1],
                                  dphi_scale);
        acc[o] = acc[o] + (d - mean[o]);
        phase[o] = (mean[o] * ramp + acc[o]) + offset[o];
      }
      // VCO 1: sine
      float s1, c1;
      sincos_fast(phase[0] + phase0_1, &s1, &c1);
      float mix = level1 * c1 * fmaxf(ctl.at(1, w, use_prev), 0.0f);
      // VCO 2: square <-> saw morph
      float s2, c2;
      sincos_fast(phase[1] + phase0_2, &s2, &c2);
      float square = tanh_fast(PI_F * partials * s2 / 2.0f);
      float osc2 = (1.0f - shape / 2.0f) * square * (1.0f + shape * c2);
      mix = mix + level2 * osc2 * fmaxf(ctl.at(3, w, use_prev), 0.0f);
      // noise
      mix = mix + level3 * seg_buf[j] * fmaxf(ctl.at(4, w, use_prev), 0.0f);
      seg_buf[j] = mix;
    }
  }
  __syncthreads();
  float* orow = out + (size_t)b * ta + start;
  for (int i = t; i < len; i += SEG_TILE) orow[i] = buf[i];
}

}  // namespace

// Launches both passes on `stream`. Pointers are device pointers to contiguous
// float32 tensors: routed [B, 5, tc], scalars [B, 16], noise and out [B, tc*ratio],
// seg_mean and seg_offset [B, 2, n_tiles*64], tile_total [B, 2, n_tiles], and
// phase_offset [B, 2, n_tiles*64] or null (then no offsets are written). Returns
// the cudaError_t of the launches (0 on success).
extern "C" int render_fwd_launch(const float* routed, const float* scalars, const float* noise,
                                 float* out, float* seg_mean, float* seg_offset,
                                 float* tile_total, float* phase_offset, int batch, int tc,
                                 int ratio, float dphi_scale, void* stream) {
  if (batch <= 0 || tc <= 0 || ratio < 1 || ratio > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (tc + SEG_TILE - 1) / SEG_TILE;
  dim3 grid(n_tiles, batch);
  render_seg_kernel<<<grid, SEG_TILE, 0, s>>>(routed, scalars, seg_mean, seg_offset, tile_total,
                                              tc, ratio, dphi_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)SEG_TILE * ratio * sizeof(float);
  render_audio_kernel<<<grid, SEG_TILE, smem, s>>>(routed, scalars, noise, seg_mean, seg_offset,
                                                   tile_total, out, phase_offset, tc, ratio,
                                                   dphi_scale);
  return (int)cudaGetLastError();
}

extern "C" int render_fwd_seg_tile() { return SEG_TILE; }
