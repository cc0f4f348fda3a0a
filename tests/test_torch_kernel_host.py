"""Host C++ check of the CUDA sources: ``biquad_cascade``, ``deesser_scan``,
``compressor_scan``, ``gate_scan``, ``cleanup_scan``, ``max_affine_scan``,
the model stages' kernels and ``env_scan``.

The kernels keep each lane's step in ``AFK_HD`` functions (``csrc/afk.cuh``)
with the ``__global__`` parts under ``__CUDACC__``, so ``g++ -x c++`` builds
the same arithmetic for the host. The small ``extern "C"`` runner below runs
each stream's lanes in the kernel's schedule: T chunked as the tile is, at
wavefront step k section (or dynamic band) s filters sample t = k - s with
the previous step's output of lane s - 1 as its input, the last lane writes
over the tile, and the de-esser calls the kernel's own phase functions
(serial: one lane per band over the chunk; parallel: one sample) in the
kernel's order over a tile of the kernel's layout. Only the warp shuffles and
the thread indexing are the runner's own. The tests hold it
against the plain PyTorch twins at
N = 3, T = 480, once with the whole block as one chunk and once in chunks of
128 samples (the crossfade weight then depends on the chunk's offset).
Tolerances: ``biquad_cascade`` y and z 1e-6 (both f64 inside);
``deesser_scan`` y 1e-4 and state 1e-3 (f32 libm against torch's
``log10``/``pow``).

``compressor_scan`` and ``gate_scan`` keep their streams' state in tables
beside the tile, so their runners only call the kernels' phase functions in
the kernels' order: serial phases lane by lane over the chunk, parallel
phases sample by sample. They run N = 11 streams (two blocks of the kernel's
eight, the second ragged) over consecutive blocks of 480 samples, each host
block from the host's own state, against the twin run the same way.
Tolerances: compressor y 1e-5 and ``current_gr_db`` 1e-3 (f32 libm against
torch's ``log10``/``pow``); gate: every integer state equal and y within 1e-4
on all but at most ``GATE_APART_MAX`` stream-blocks, where libm and torch may
differ by an ulp at a threshold test.

``cleanup_scan`` runs the kernel's two parts over the kernel's tile: the f64
wavefront (three stages, five lanes a stream, the pending lane's output to
the notch's first lane within the step, four streams to a warp's vote on
whether any notch fades) and the rumble detector's phases, the rumble hold
from the last sample whose trigger fired. 11 streams, gentle and strong, with
crossfades in flight and idle, the window's boundary inside the block, and
streams on which the trigger fires and on which it cannot; blocks of 480
samples (one chunk), 960 (two chunks, the kernel's own split) and 480 in
chunks of 128. Tolerances: y 1e-6 and the notch state 1e-9 (f64 inside; the
DC blocker runs in DF2T form, which rounds in another order than the twin's
``x - x1 + c y1``); the rumble envelopes and the rumble hold equal.
``max_affine_scan`` and its limiter form ``limiter_gain_scan`` run the same
way (tile, chunks, serial loop, per-sample phases) on lookahead-limiter- and
true-peak-limiter-shaped inputs, equal to their twins to the bit.
``env_scan`` runs on its kernel's chunk schedule over the kernel's ring of
column-major strip tiles (the serial phase a column a lane, four samples a
read, the log a chunk behind), at T = 480 and 1000 and B = 16, 17 and 1.

Needs ``g++``; without it the tests skip with a reason.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from audioforge_tpu_torch.models import dfn3 as tdfn
from audioforge_tpu_torch.models import silero as tsil
from audioforge_tpu_torch.ops import biquad as tbq
from audioforge_tpu_torch.ops import compressor as tcomp
from audioforge_tpu_torch.ops import deesser as tdes
from audioforge_tpu_torch.ops import envelope as tenv
from audioforge_tpu_torch.ops import resample as tres
from audioforge_tpu_torch.ops import gate as tgate
from audioforge_tpu_torch.ops import routing as troute
from audioforge_tpu_torch.ops import scan as tscan

N, T, FS = 3, 480, 48000.0
CHUNKS = [T, 128]
CSRC = Path(tbq.__file__).resolve().parents[1] / "csrc"

RUNNER = r"""
#include <algorithm>
#include <vector>
#include "biquad_cascade.cu"
#include "cleanup_scan.cu"
#include "compressor_scan.cu"
#include "deesser_scan.cu"
#include "gate_scan.cu"
#include "max_affine_scan.cu"
#include "vad_front.cu"
#include "silero_lstm.cu"
#include "dfn_features.cu"
#include "dfn_synth.cu"
#include "env_scan.cu"

// vad_front per stream, as its block runs it: the ext row and the kept
// window staged, thread o's decimated sample, the history, then the frames'
// quads and the window's quads.
extern "C" int host_vad_front(const float* x, const float* hist, const float* window,
                              float gain, float* hist_out, float* window_out,
                              float* frames, int N) {
    for (int n = 0; n < N; ++n) {
        float ext[VF_EXT_LEN], win[VF_WIN];
        std::copy(hist + n * VF_HIST, hist + (n + 1) * VF_HIST, ext + VF_EXT0);
        std::copy(x + n * VF_BLOCK, x + (n + 1) * VF_BLOCK, ext + VF_EXT0 + VF_HIST);
        std::copy(window + n * VF_WIN + VF_OUT, window + (n + 1) * VF_WIN, win);
        for (int o = 0; o < VF_OUT; ++o) win[VF_KEEP + o] = vf_decimate(ext + VF_EXT0, o);
        std::copy(ext + VF_EXT0 + VF_BLOCK, ext + VF_EXT0 + VF_BLOCK + VF_HIST,
                  hist_out + n * VF_HIST);
        for (int q = 0; q < VF_QUADS; ++q) {
            const float4 v = vf_frame_quad(win, q, gain);
            float* out = frames + n * VF_FRAMES * VF_FRAME + 4 * q;
            out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
        }
        for (int q = 0; q < VF_WIN / 4; ++q) {
            const float4 v = afk_load4(win + 4 * q);
            float* out = window_out + n * VF_WIN + 4 * q;
            out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
        }
    }
    return 0;
}

// vad_lstm_head per stream, as its block runs it: thread u's unit, the
// head's dot a butterfly on each warp (lane 0's sum), the warps' parts added
// in warp order, thread 0's tail.
extern "C" int host_vad_lstm_head(const float* gates, const float* lstm, const float* bi,
                                  const float* bh, const float* head_w, float head_b,
                                  const float* smoothed, const int* seen, float smoothing,
                                  float* lstm_out, float* smoothed_out, int* seen_out,
                                  float* prob, bool* avail, int N, int warmup_blocks) {
    const int H = VL_HIDDEN;
    for (int n = 0; n < N; ++n) {
        const float* g = gates + n * 4 * H;
        float part[VL_HIDDEN];
        for (int u = 0; u < H; ++u)
            part[u] = vl_unit(g[u], g[H + u], g[2 * H + u], g[3 * H + u], bi[u], bi[H + u],
                              bi[2 * H + u], bi[3 * H + u], bh[u], bh[H + u], bh[2 * H + u],
                              bh[3 * H + u], lstm[n * 2 * H + H + u], head_w[u],
                              lstm_out + n * 2 * H + u, lstm_out + n * 2 * H + H + u);
        float dot = 0.0f;
        for (int w = 0; w < VL_WARPS; ++w) {
            float* lanes = part + 32 * w;
            for (int o = 16; o > 0; o >>= 1) {
                float next[32];
                for (int lane = 0; lane < 32; ++lane) next[lane] = lanes[lane] + lanes[lane ^ o];
                std::copy(next, next + 32, lanes);
            }
            dot = w == 0 ? lanes[0] : dot + lanes[0];
        }
        vl_finish(dot, head_b, smoothing, smoothed[n], seen[n], warmup_blocks,
                  smoothed_out + n, seen_out + n, prob + n, avail + n);
    }
    return 0;
}

// env_scan per strip of ES_WIDTH columns, on the kernel's chunk schedule
// over its ring of column-major tiles: ES_AHEAD chunks copied first, then
// round k runs the serial phase of chunk k, the copy of chunk
// k + ES_AHEAD - 1 and the log of chunk k - 1. The kernel runs a round's
// copy and log beside the serial phase; here they come after it, and the
// copy before the log, the order in which a tile reused too early would
// show.
extern "C" int host_env_scan(const float* x, const float* env_in, float* y, float* env_out,
                             int T, int B) {
    std::vector<float> ring(ES_STAGES * ES_TILE);
    const int chunks = (T + ES_CHUNK - 1) / ES_CHUNK;
    for (int b0 = 0; b0 < B; b0 += ES_WIDTH) {
        const int width = std::min(ES_WIDTH, B - b0);
        float env[ES_WIDTH];
        for (int w = 0; w < width; ++w) env[w] = env_in[b0 + w];
        auto tile = [&](int k) { return ring.data() + (k % ES_STAGES) * ES_TILE; };
        auto copy = [&](int k) {
            if (k >= chunks) return;
            std::fill(tile(k), tile(k) + ES_TILE, NAN);
            for (int r = 0; r < env_scan_rows(T, k); ++r)
                for (int c = 0; c < width; ++c)
                    tile(k)[c * ES_STRIDE + r] = x[(long long)(k * ES_CHUNK + r) * B + b0 + c];
        };
        auto log = [&](int k) {
            for (int r = 0; r < env_scan_rows(T, k); ++r)
                for (int c = 0; c < width; ++c)
                    y[(long long)(k * ES_CHUNK + r) * B + b0 + c] =
                        env_scan_log(tile(k)[c * ES_STRIDE + r]);
        };
        for (int k = 0; k < ES_AHEAD; ++k) copy(k);
        for (int k = 0; k < chunks; ++k) {
            for (int w = 0; w < width; ++w)
                env[w] = env_scan_chunk(tile(k) + w * ES_STRIDE, env_scan_rows(T, k), env[w]);
            if (k > 0) {
                copy(k - 1 + ES_AHEAD);
                log(k - 1);
            }
        }
        if (chunks > 0) log(chunks - 1);
        for (int w = 0; w < width; ++w) env_out[b0 + w] = env[w];
    }
    return 0;
}

// dfn_features per stream, as its block runs it: the power row and the low
// bins, part w of band b as lane b of warp w sums it, then the parts added
// in warp order by lane b of warp 0.
extern "C" int host_dfn_features(const float* spec, const float* erb_norm,
                                 const float* unit_norm, const int* offsets,
                                 float* feat_erb, float* feat_spec, float* erb_norm_out,
                                 float* unit_norm_out, int N, float alpha, float one_minus) {
    for (int n = 0; n < N; ++n) {
        float power[DFF_FREQ], part[DFF_PARTS][DFF_ERB];
        for (int k = 0; k < DFF_FREQ; ++k) {
            const float re = spec[(n * DFF_FREQ + k) * 2], im = spec[(n * DFF_FREQ + k) * 2 + 1];
            power[k] = dff_power(re, im);
            if (k < DFF_DF)
                dff_low_bin(re, im, unit_norm[n * DFF_DF + k], alpha, one_minus,
                            unit_norm_out + n * DFF_DF + k, feat_spec + n * 2 * DFF_DF + k,
                            feat_spec + n * 2 * DFF_DF + DFF_DF + k);
        }
        for (int w = 0; w < DFF_PARTS; ++w)
            for (int b = 0; b < DFF_ERB; ++b)
                part[w][b] = dff_band_part(power, offsets[b], offsets[b + 1], w);
        for (int b = 0; b < DFF_ERB; ++b) {
            float sum = part[0][b];
            for (int w = 1; w < DFF_PARTS; ++w) sum += part[w][b];
            dff_band(sum, offsets[b], offsets[b + 1], erb_norm[n * DFF_ERB + b], alpha,
                     one_minus, erb_norm_out + n * DFF_ERB + b, feat_erb + n * DFF_ERB + b);
        }
    }
    return 0;
}

// dfn_spec_synth per stream: the gains as threads 0-31 stage them, then
// every bin.
extern "C" int host_dfn_spec_synth(const float* x_tgt, const float* erb_gains,
                                   const float* coefs, const float* hist,
                                   const int* bin_band, float atten_lim_db, float beta,
                                   float* y, int N) {
    for (int n = 0; n < N; ++n) {
        float gains[DFS_ERB];
        for (int b = 0; b < DFS_ERB; ++b) {
            const float g = erb_gains[n * DFS_ERB + b];
            gains[b] = beta > 0.0f ? dfs_post_filter(g, beta) : g;
        }
        const float floor_gain = dfs_floor_gain(atten_lim_db);
        const int tap0 = n * DFS_ORDER * DFS_DF * 2;
        for (int k = 0; k < DFS_FREQ; ++k) {
            const float* X = x_tgt + (n * DFS_FREQ + k) * 2;
            const bool low = k < DFS_DF;
            const DfsComplex fir = low ? dfs_fir(coefs + tap0, hist + tap0, k) : DfsComplex{};
            const DfsComplex out = dfs_bin({X[0], X[1]}, gains[bin_band[k]], low, fir,
                                           floor_gain);
            y[(n * DFS_FREQ + k) * 2] = out.re;
            y[(n * DFS_FREQ + k) * 2 + 1] = out.im;
        }
    }
    return 0;
}

extern "C" int host_biquad_cascade(const float* x, const float* coeffs,
                                   const double* z_in, const int* fade_total,
                                   const int* fade_remaining, float* y,
                                   double* z_out, int N, int S, int T, int tc_max) {
    if (S < 1 || S > AFK_BIQUAD_MAX_SECTIONS || tc_max < 1) return 1;
    std::vector<float> row(std::max(T, 1));
    for (int n = 0; n < N; ++n) {
        BiquadLane L[AFK_BIQUAD_MAX_SECTIONS];
        double v[AFK_BIQUAD_MAX_SECTIONS] = {};
        for (int s = 0; s < S; ++s) {
            const long long sec = (long long)n * S + s;
            bq_lane_load(L[s], coeffs + sec * 10, z_in + sec * 4, fade_total[sec],
                         fade_remaining[sec]);
        }
        // as the kernel's warp vote: the pending lanes run where any fades
        bool fade = false;
        for (int s = 0; s < S; ++s) fade = fade || L[s].fading;
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            std::copy(x + (long long)n * T + c0, x + (long long)n * T + c0 + tc,
                      row.begin());
            for (int kb = 0; kb < tc + S - 1; kb += BQ_GROUP) {
                double w[AFK_BIQUAD_MAX_SECTIONS][BQ_GROUP] = {};
                for (int s = 0; s < S && fade; ++s) bq_group_weights(L[s], kb, s, c0, w[s]);
                for (int k = kb; k < kb + BQ_GROUP; ++k) {
                    // as __shfl_up_sync: lane s takes lane s-1's output of step k-1
                    double in[AFK_BIQUAD_MAX_SECTIONS];
                    in[0] = k < tc ? row[k] : 0.0;
                    for (int s = 1; s < S; ++s) in[s] = v[s - 1];
                    const bool check = !bq_group_steady(kb, S, tc);
                    for (int s = 0; s < S; ++s) {
                        auto* step = fade ? (check ? bq_wave_step<true, true>
                                                   : bq_wave_step<true, false>)
                                          : (check ? bq_wave_step<false, true>
                                                   : bq_wave_step<false, false>);
                        step(L[s], v[s], in[s], w[s][k - kb], k, s, S, true, tc, row.data());
                    }
                }
            }
            std::copy(row.begin(), row.begin() + tc, y + (long long)n * T + c0);
        }
        for (int s = 0; s < S; ++s)
            bq_lane_store(L[s], z_out + ((long long)n * S + s) * 4);
    }
    return 0;
}

// One thread block's work: the phases in the kernel's order over the same
// tile rows, each lane (serial phases) or sample (parallel phases) in turn.
template <bool AUTO>
static void host_deesser(const float* x, const float* s_in, float* y, float* s_out,
                         int N, int T, int tc_max, const DeesserConsts& k) {
    const int stride = std::max(tc_max, 1);
    std::vector<float> tile(DR_ROWS * DS_STREAMS * stride);
    float* tl = tile.data();
    for (int n0 = 0; n0 < N; n0 += DS_STREAMS) {
        const int rows = std::min(DS_STREAMS, N - n0);
        DsLane L[DS_STREAMS][DS_LANES];
        for (int g = 0; g < rows; ++g)
            for (int l = 0; l < DS_LANES; ++l) ds_lane_load(L[g][l], l, s_in + n0 + g, N, k);
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            for (int g = 0; g < rows; ++g)
                std::copy(x + (long long)(n0 + g) * T + c0,
                          x + (long long)(n0 + g) * T + c0 + tc, ds_row(tl, stride, DR_X, g));
            for (int g = 0; g < rows; ++g)  // A
                for (int l = 0; l < DS_LANES; ++l) ds_phase_detect(L[g][l], l, tl, stride, g, tc, k);
            for (int g = 0; g < rows; ++g)  // B
                for (int t = 0; t < tc; ++t) ds_sample_inputs<AUTO>(tl, stride, g, t);
            for (int g = 0; g < rows; ++g)  // C
                for (int b = 0; b < DS_BANDS; ++b)
                    ds_phase_recur<AUTO>(L[g][b], b, tl, stride, g, tc, k);
            for (int g = 0; g < rows; ++g)  // D
                for (int t = 0; t < tc; ++t) ds_sample_targets<AUTO>(tl, stride, g, t, k);
            for (int g = 0; g < rows; ++g)  // E
                for (int b = 0; b < DS_BANDS; ++b) ds_phase_reduce(L[g][b], b, tl, stride, g, tc, k);
            for (int b = 0; b < DS_BANDS; ++b)  // F
                for (int g = 0; g < rows; ++g)
                    for (int t = 0; t < tc; ++t) ds_sample_coeffs(tl, stride, b, g, t, k);
            for (int g = 0; g < rows; ++g) {  // G: the dynamic bands as a wavefront
                float* row = ds_row(tl, stride, DR_X, g);
                float v[DS_LANES] = {};
                for (int kk = 0; kk < tc + DS_BANDS - 1; ++kk) {
                    // as __shfl_up_sync: band b takes band b-1's output of step kk-1
                    const float in[DS_LANES] = {kk < tc ? row[kk] : 0.0f, v[0], v[1], v[2]};
                    for (int l = 0; l < DS_LANES; ++l) {
                        float c[5];
                        ds_coeffs_at(tl, stride, std::min(l, DS_BANDS - 1), g,
                                     std::max(0, std::min(kk - l, tc - 1)), c);
                        ds_dyn_wave_step(L[g][l], v[l], in[l], c, kk, l, tc, row);
                    }
                }
                std::copy(row, row + tc, y + (long long)(n0 + g) * T + c0);
            }
        }
        for (int g = 0; g < rows; ++g) {
            DsLane* Lg = L[g];
            if (T > 0) {
                Lg[DS_BANDS].red = ds_total_reduction(Lg[0].red, Lg[1].red, Lg[2].red, k);
                Lg[DS_BANDS].conf = ds_detector_confidence(Lg[0].conf, Lg[1].conf, Lg[2].conf);
            }
            for (int l = 0; l < DS_LANES; ++l) ds_lane_store(Lg[l], l, s_out + n0 + g, N);
        }
    }
}

// Weights n / d for which afk_quotient and the division differ, over every
// integer d in [1, max_d] and n in [1, d + extra].
extern "C" long long host_quotient_mismatches(int max_d, int extra) {
    long long bad = 0;
    for (int d = 1; d <= max_d; ++d) {
        const double dd = d, rcp = 1.0 / dd;
        for (int n = 1; n <= d + extra; ++n)
            bad += afk_quotient((double)n, dd, rcp) != (double)n / dd;
    }
    return bad;
}

extern "C" int host_deesser_scan(const float* x, const float* s_in, float* y,
                                 float* s_out, int N, int T, const float* consts,
                                 int n_consts, int auto_mode, int tc_max) {
    if (n_consts != DS_CONSTS || tc_max < 1) return 1;
    DeesserConsts k;
    std::memcpy(&k, consts, sizeof(k));
    if (auto_mode)
        host_deesser<true>(x, s_in, y, s_out, N, T, tc_max, k);
    else
        host_deesser<false>(x, s_in, y, s_out, N, T, tc_max, k);
    return 0;
}

// One thread block's work per group of CS_STREAMS streams: the phases in the
// kernel's order over the kernel's tile and tables.
template <bool SC, bool ADAPT>
static void host_compressor(const float* x, const float* params, const float* s_in, float* y,
                            float* s_out, int N, int T, int tc_max,
                            const CompressorConsts& k) {
    const int stride = afk_tile_stride(tc_max);
    std::vector<float> tile(CR_ROWS * CS_STREAMS * stride);
    std::vector<float> st(CS_STATE_ROWS * CS_STREAMS), pr(P_COUNT * CS_STREAMS);
    float* tl = tile.data();
    for (int n0 = 0; n0 < N; n0 += CS_STREAMS) {
        const int rows = std::min<int>(CS_STREAMS, N - n0);
        for (int g = 0; g < rows; ++g) {
            for (int i = 0; i < S_COUNT; ++i) cs_at(st.data(), i, g) = s_in[i * N + n0 + g];
            for (int i = 0; i < P_COUNT; ++i) cs_at(pr.data(), i, g) = params[i * N + n0 + g];
        }
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            for (int g = 0; g < rows; ++g)
                std::copy(x + (long long)(n0 + g) * T + c0,
                          x + (long long)(n0 + g) * T + c0 + tc, cs_row(tl, stride, CR_X, g));
            for (int g = 0; g < rows && SC; ++g)  // A
                cs_phase_highpass(tl, stride, g, tc, st.data(), pr.data());
            for (int g = 0; g < rows; ++g)  // B
                for (int t = 0; t < tc; ++t) cs_sample_drives<SC>(tl, stride, g, t, pr.data(), k);
            for (int g = 0; g < rows; ++g) {  // C
                for (int lane = 0; lane < CS_LANES; ++lane)
                    if (cs_lane_runs<SC>(lane))
                        cs_phase_one_pole(lane, tl, stride, g, tc, st.data(), k);
                cs_phase_peak(tl, stride, g, tc, st.data(), pr.data());
            }
            for (int g = 0; g < rows && !ADAPT; ++g)
                cs_phase_release_base(tl, stride, g, tc, st.data(), pr.data(), k);
            for (int g = 0; g < rows; ++g)  // D
                for (int t = 0; t < tc; ++t)
                    cs_sample_target<SC, ADAPT>(tl, stride, g, t, tc, st.data(), pr.data(), k);
            for (int g = 0; g < rows; ++g)  // E
                cs_phase_reduction<ADAPT>(tl, stride, g, tc, st.data(), pr.data(), k);
            for (int g = 0; g < rows; ++g)  // F
                for (int t = 0; t < tc; ++t)
                    cs_sample_output<ADAPT>(tl, stride, g, t, st.data(), pr.data());
            for (int g = 0; g < rows && ADAPT; ++g)  // G
                cs_phase_release(tl, stride, g, tc, st.data(), k);
            for (int g = 0; g < rows; ++g)
                std::copy(cs_row(tl, stride, CR_X, g), cs_row(tl, stride, CR_X, g) + tc,
                          y + (long long)(n0 + g) * T + c0);
        }
        for (int g = 0; g < rows; ++g)
            for (int i = 0; i < S_COUNT; ++i) s_out[i * N + n0 + g] = cs_at(st.data(), i, g);
    }
}

extern "C" int host_compressor_scan(const float* x, const float* params, const float* s_in,
                                    float* y, float* s_out, int N, int T,
                                    const float* consts, int adaptive, int sidechain,
                                    int tc_max) {
    if (tc_max < 1) return 1;
    const CompressorConsts k{consts[0], consts[1], consts[2], consts[3],
                             consts[4], consts[5], consts[6]};
    auto* run = sidechain ? (adaptive ? host_compressor<true, true> : host_compressor<true, false>)
                          : (adaptive ? host_compressor<false, true>
                                      : host_compressor<false, false>);
    run(x, params, s_in, y, s_out, N, T, tc_max, k);
    return 0;
}

template <int MODE>
static void host_gate(const float* x, const float* params, const float* vad,
                      const float* fs_in, const int* is_in, float* y, float* fs_out,
                      int* is_out, int N, int T, int tc_max, const GateConsts& k) {
    const int stride = afk_tile_stride(tc_max);
    std::vector<float> tile(GR_ROWS * GT_STREAMS * stride);
    std::vector<float> fs(GF_COUNT * GT_STREAMS), pr(GP_COUNT * GT_STREAMS),
        vd(GV_COUNT * GT_STREAMS);
    std::vector<int> is(GI_COUNT * GT_STREAMS);
    const GateTables tb{fs.data(), is.data(), pr.data(), vd.data()};
    float* tl = tile.data();
    for (int n0 = 0; n0 < N; n0 += GT_STREAMS) {
        const int rows = std::min<int>(GT_STREAMS, N - n0);
        for (int g = 0; g < rows; ++g) {
            for (int i = 0; i < GF_COUNT; ++i) fs[gt_at(i, g)] = fs_in[i * N + n0 + g];
            for (int i = 0; i < GI_COUNT; ++i) is[gt_at(i, g)] = is_in[i * N + n0 + g];
            for (int i = 0; i < GP_COUNT; ++i) pr[gt_at(i, g)] = params[i * N + n0 + g];
            for (int i = 0; i < GV_COUNT; ++i) vd[gt_at(i, g)] = vad[i * N + n0 + g];
        }
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            for (int g = 0; g < rows; ++g)
                std::copy(x + (long long)(n0 + g) * T + c0,
                          x + (long long)(n0 + g) * T + c0 + tc, gt_row(tl, stride, GR_X, g));
            for (int g = 0; g < rows; ++g) {  // A
                gt_phase_rms(tl, stride, g, tc, tb, k);
                if (MODE != GATE_THRESHOLD_ONLY) gt_phase_smooth(tl, stride, g, tc, tb, k);
            }
            for (int g = 0; g < rows; ++g)  // B
                for (int t = 0; t < tc; ++t) gt_sample_level<MODE>(tl, stride, g, t, tc, tb);
            for (int g = 0; g < rows; ++g)  // C
                gt_phase_detect(tl, stride, g, tc, tb, k);
            for (int g = 0; g < rows; ++g)  // D
                for (int t = 0; t < tc; ++t) gt_sample_target<MODE>(tl, stride, g, t, tb);
            for (int g = 0; g < rows; ++g) {  // E
                gt_phase_gain<MODE>(tl, stride, g, tc, tb, k);
                if (MODE == GATE_THRESHOLD_ONLY) gt_phase_chatter(tl, stride, g, tc, tb, k);
            }
            for (int g = 0; g < rows; ++g) {  // F
                for (int t = 0; t < tc; ++t) gt_sample_output(tl, stride, g, t);
                std::copy(gt_row(tl, stride, GR_X, g), gt_row(tl, stride, GR_X, g) + tc,
                          y + (long long)(n0 + g) * T + c0);
            }
        }
        for (int g = 0; g < rows; ++g) {
            gt_finish<MODE>(tb, g);
            for (int i = 0; i < GF_COUNT; ++i) fs_out[i * N + n0 + g] = fs[gt_at(i, g)];
            for (int i = 0; i < GI_COUNT; ++i) is_out[i * N + n0 + g] = is[gt_at(i, g)];
        }
    }
}

extern "C" int host_gate_scan(const float* x, const float* params, const float* vad,
                              const float* fs_in, const int* is_in, float* y, float* fs_out,
                              int* is_out, int N, int T, int mode, const float* fconsts,
                              const int* iconsts, int tc_max) {
    if (tc_max < 1 || mode < 0 || mode > 2) return 1;
    const GateConsts k{fconsts[0], fconsts[1], fconsts[2], fconsts[3],
                       iconsts[0], iconsts[1], iconsts[2], iconsts[3]};
    auto* run = mode == GATE_THRESHOLD_ONLY ? host_gate<GATE_THRESHOLD_ONLY>
                : mode == GATE_VAD_ASSISTED ? host_gate<GATE_VAD_ASSISTED>
                                            : host_gate<GATE_VAD_ONLY>;
    run(x, params, vad, fs_in, is_in, y, fs_out, is_out, N, T, tc_max, k);
    return 0;
}

// Steps k0 .. k0+3 of one stream's wavefront: its five lanes in lockstep.
template <bool FADE, bool CHECK>
static void host_cleanup_group(CleanupLane* L, double* v, const float* xrow, float* yrow,
                               int k0, int c0, int tc) {
    double w[CL_USED_LANES][CL_GROUP];
    for (int l = 0; l < CL_USED_LANES; ++l) {
        for (int j = 0; j < CL_GROUP; ++j) w[l][j] = 1.0;
        if (FADE) cl_group_weights(L[l], k0, cl_lane_stage(l), c0, w[l]);
    }
    for (int j = 0; j < CL_GROUP; ++j) {
        // as __shfl_sync: every lane takes its source's output of the step before
        double in[CL_USED_LANES], y[CL_USED_LANES];
        bool valid[CL_USED_LANES];
        for (int l = 0; l < CL_USED_LANES; ++l) {
            const int t = k0 + j - cl_lane_stage(l);
            valid[l] = !CHECK || (t >= 0 && t < tc);
            in[l] = cl_lane_stage(l) > 0 ? v[cl_lane_source(l)]
                                         : (double)xrow[std::min(k0 + j, tc - 1)];
        }
        for (int l = 0; l < CL_USED_LANES; ++l) y[l] = cl_lane_filter<CHECK>(L[l], in[l], valid[l]);
        for (int l = 0; l < CL_USED_LANES; ++l) {
            // as __shfl_down_sync: the next lane's output of this step
            const double ya = FADE && l + 1 < CL_USED_LANES ? y[l + 1] : y[l];
            const double out = cl_lane_mix<FADE>(L[l], in[l], y[l], ya, w[l][j]);
            if (!valid[l]) continue;
            v[l] = out;
            if (l == CL_LAST_MIX) yrow[k0 + j - cl_lane_stage(l)] = (float)out;
        }
    }
}

// One thread block's work per group of CL_STREAMS streams: the wavefront and
// the rumble detector's phases over the kernel's tile and tables. tc_max 0:
// the chunk the launcher picks.
extern "C" int host_cleanup_scan(const float* x, const float* fin, const float* hum_c,
                                 const float* harm_c, const double* hum_z,
                                 const double* harm_z, const int* iin, float* y, float* fout,
                                 double* hum_zout, double* harm_zout, int* iout, int N, int T,
                                 const float* fconsts, const int* iconsts, double dc_coeff,
                                 int tc_max) {
    const CleanupConsts k{fconsts[0], fconsts[1], fconsts[2], iconsts[0], iconsts[1], dc_coeff};
    if (tc_max == 0)
        tc_max = std::max(afk_tile_chunk(T, KR_ROWS * CL_STREAMS, CL_TILE_SMEM_BYTES), 4);
    const int stride = afk_tile_stride(tc_max);
    std::vector<float> tile(KR_ROWS * CL_STREAMS * stride), fs(CF_RUMBLE * CL_STREAMS);
    std::vector<int> ci(CI_COUNT * CL_STREAMS), t_last(CL_STREAMS);
    float* tl = tile.data();
    for (int n0 = 0; n0 < N; n0 += CL_STREAMS) {
        const int rows = std::min<int>(CL_STREAMS, N - n0);
        CleanupLane L[CL_STREAMS][CL_USED_LANES];
        double v[CL_STREAMS][CL_USED_LANES] = {};
        bool fade[CL_STREAMS / 4] = {};  // as the kernel's warp vote: four streams a warp
        for (int g = 0; g < rows; ++g) {
            const long long n = n0 + g;
            for (int i = 0; i < CI_COUNT; ++i) ci[cl_at(i, g)] = iin[(long long)i * N + n];
            for (int i = 0; i < CF_RUMBLE; ++i) fs[cl_at(i, g)] = fin[(long long)i * N + n];
            t_last[g] = -1;
            for (int l = 0; l < CL_USED_LANES; ++l) {
                cl_lane_load(L[g][l], l, fin + n, N, hum_c + n * 10, harm_c + n * 10,
                             hum_z + n * 4, harm_z + n * 4, iin[(long long)CI_FADE_HUM * N + n],
                             iin[(long long)CI_FADE_HARM * N + n], k);
                fade[g / 4] = fade[g / 4] || L[g][l].fading;
            }
        }
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            for (int g = 0; g < rows; ++g)
                std::copy(x + (n0 + g) * (long long)T + c0, x + (n0 + g) * (long long)T + c0 + tc,
                          cl_row(tl, stride, KR_X, g));
            for (int g = 0; g < rows; ++g) {
                const float* xrow = cl_row(tl, stride, KR_X, g);
                float* yrow = cl_row(tl, stride, KR_Y, g);
                for (int kb = 0; kb < tc + CL_STAGES - 1; kb += CL_GROUP) {
                    const bool check = !cl_group_steady(kb, tc);
                    auto* group = fade[g / 4]
                        ? (check ? host_cleanup_group<true, true> : host_cleanup_group<true, false>)
                        : (check ? host_cleanup_group<false, true>
                                 : host_cleanup_group<false, false>);
                    group(L[g], v[g], xrow, yrow, kb, c0, tc);
                }
            }
            for (int g = 0; g < rows; ++g) {  // A
                cl_phase_lowpass(tl, stride, g, tc, fs.data(), k);
                cl_phase_broad(tl, stride, g, tc, fs.data());
            }
            for (int g = 0; g < rows; ++g) {  // B
                cl_phase_low(tl, stride, g, tc, fs.data());
                cl_phase_slow(tl, stride, g, tc, fs.data());
            }
            for (int g = 0; g < rows; ++g)  // C, as the atomicMax
                for (int t = 0; t < tc; ++t)
                    if (cl_sample_trigger(tl, stride, g, t, c0 + t, ci.data(), k))
                        t_last[g] = std::max(t_last[g], c0 + t);
            for (int g = 0; g < rows; ++g)
                std::copy(cl_row(tl, stride, KR_Y, g), cl_row(tl, stride, KR_Y, g) + tc,
                          y + (n0 + g) * (long long)T + c0);
        }
        for (int g = 0; g < rows; ++g) {
            const long long n = n0 + g;
            for (int i = 0; i < CF_RUMBLE; ++i) fout[(long long)i * N + n] = fs[cl_at(i, g)];
            iout[n] = cl_rumble_hold_end(ci[cl_at(CI_RUMBLE_HOLD, g)], t_last[g], T,
                                         k.rumble_hold_set);
            fout[(long long)CF_DC_X1 * N + n] = x[n * T + T - 1];
            fout[(long long)CF_DC_Y1 * N + n] = (float)v[g][0];
            for (int l = 1; l < CL_USED_LANES; ++l)
                cl_lane_store(L[g][l], (l <= 2 ? hum_zout : harm_zout) + n * 4 + ((l - 1) % 2) * 2);
        }
    }
    return 0;
}

extern "C" int host_max_affine_scan(const float* v, const float* c, const float* rho,
                                    const float* u0, float* u, int N, int T, int tc_max) {
    if (tc_max == 0) tc_max = ma_chunk(T, MR_ROWS);
    const int stride = afk_tile_stride(tc_max);
    std::vector<float> tile(MR_ROWS * MA_STREAMS * stride);
    float* tl = tile.data();
    for (int n0 = 0; n0 < N; n0 += MA_STREAMS) {
        const int rows = std::min<int>(MA_STREAMS, N - n0);
        float carry[MA_STREAMS];
        for (int g = 0; g < rows; ++g) carry[g] = u0[n0 + g];
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            for (int g = 0; g < rows; ++g) {
                const long long at = (n0 + g) * (long long)T + c0;
                std::copy(v + at, v + at + tc, ma_row(tl, stride, MR_V, g));
                std::copy(c + at, c + at + tc, ma_row(tl, stride, MR_C, g));
            }
            for (int g = 0; g < rows; ++g)
                carry[g] = ma_phase_scan(tl, stride, MR_V, MR_C, g, tc, rho[n0 + g], carry[g]);
            for (int g = 0; g < rows; ++g)
                std::copy(ma_row(tl, stride, MR_V, g), ma_row(tl, stride, MR_V, g) + tc,
                          u + (n0 + g) * (long long)T + c0);
        }
    }
    return 0;
}

extern "C" int host_limiter_gain_scan(const float* peak, int peak_ld, const float* xd, int xd_ld,
                                      const float* ceiling, const float* rc, const float* gain0,
                                      float scale, float* y, float* gain_last, float* min_gain,
                                      int* events, int N, int T, int tc_max) {
    if (tc_max == 0) tc_max = ma_chunk(T, LR_ROWS);
    const int stride = afk_tile_stride(tc_max);
    std::vector<float> tile(LR_ROWS * MA_STREAMS * stride);
    float* tl = tile.data();
    for (int n0 = 0; n0 < N; n0 += MA_STREAMS) {
        const int rows = std::min<int>(MA_STREAMS, N - n0);
        float carry[MA_STREAMS], before[MA_STREAMS], least[MA_STREAMS];
        bool fired[MA_STREAMS] = {};
        for (int g = 0; g < rows; ++g) {
            carry[g] = 1.0f - gain0[n0 + g];
            before[g] = gain0[n0 + g];
            least[g] = INFINITY;
        }
        for (int c0 = 0; c0 < T; c0 += tc_max) {
            const int tc = std::min(tc_max, T - c0);
            for (int g = 0; g < rows; ++g) {
                const float* p = peak + (n0 + g) * (long long)peak_ld + c0;
                const float* d = xd + (n0 + g) * (long long)xd_ld + c0;
                std::copy(p, p + tc, ma_row(tl, stride, LR_TARGET, g));
                std::copy(d, d + tc, ma_row(tl, stride, LR_X, g));
            }
            for (int g = 0; g < rows; ++g)  // 1
                for (int t = 0; t < tc; ++t)
                    lg_sample_target(tl, stride, g, t, ceiling[n0 + g], scale, rc[n0 + g]);
            for (int g = 0; g < rows; ++g)  // 2
                carry[g] = ma_phase_scan(tl, stride, LR_V, LR_C, g, tc, rc[n0 + g], carry[g]);
            for (int g = 0; g < rows; ++g) {  // 3, the reductions as the warp's
                for (int t = 0; t < tc; ++t) {
                    bool event;
                    least[g] = std::min(least[g], lg_sample_output(tl, stride, g, t, ceiling[n0 + g],
                                                                   before[g], event));
                    fired[g] = fired[g] || event;
                }
                before[g] = 1.0f - carry[g];
                std::copy(ma_row(tl, stride, LR_X, g), ma_row(tl, stride, LR_X, g) + tc,
                          y + (n0 + g) * (long long)T + c0);
            }
        }
        for (int g = 0; g < rows; ++g) {
            min_gain[n0 + g] = least[g];
            events[n0 + g] = fired[g];
            gain_last[n0 + g] = before[g];
        }
    }
    return 0;
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The six kernel sources built for the host behind the runner."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the CUDA sources needs it")
    tmp = tmp_path_factory.mktemp("kernel_host")
    src = tmp / "runner.cpp"
    src.write_text(RUNNER)
    lib_path = tmp / "libafk_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
           "-ffp-contract=off", "-I", str(CSRC), "-o", str(lib_path), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    assert proc.returncode == 0, f"{' '.join(cmd)}\n{proc.stderr}"
    lib = ctypes.CDLL(str(lib_path))
    lib.host_biquad_cascade.argtypes = (_P,) * 7 + (_I,) * 4
    lib.host_biquad_cascade.restype = _I
    lib.host_deesser_scan.argtypes = (_P,) * 4 + (_I, _I, _P, _I, _I, _I)
    lib.host_deesser_scan.restype = _I
    lib.host_compressor_scan.argtypes = (_P,) * 5 + (_I, _I, _P, _I, _I, _I)
    lib.host_compressor_scan.restype = _I
    lib.host_gate_scan.argtypes = (_P,) * 8 + (_I, _I, _I, _P, _P, _I)
    lib.host_gate_scan.restype = _I
    lib.host_cleanup_scan.argtypes = (_P,) * 12 + (_I, _I, _P, _P, ctypes.c_double, _I)
    lib.host_cleanup_scan.restype = _I
    lib.host_max_affine_scan.argtypes = (_P,) * 5 + (_I, _I, _I)
    lib.host_max_affine_scan.restype = _I
    lib.host_limiter_gain_scan.argtypes = (
        (_P, _I, _P, _I, _P, _P, _P, ctypes.c_float) + (_P,) * 4 + (_I, _I, _I))
    lib.host_limiter_gain_scan.restype = _I
    lib.host_vad_front.argtypes = (_P, _P, _P, ctypes.c_float, _P, _P, _P, _I)
    lib.host_vad_front.restype = _I
    lib.afk_vad_front_tap.argtypes = (_I,)
    lib.afk_vad_front_tap.restype = ctypes.c_float
    lib.host_vad_lstm_head.argtypes = ((_P,) * 5 + (ctypes.c_float, _P, _P, ctypes.c_float)
                                       + (_P,) * 5 + (_I, _I))
    lib.host_vad_lstm_head.restype = _I
    lib.host_dfn_features.argtypes = (_P,) * 8 + (_I, ctypes.c_float, ctypes.c_float)
    lib.host_dfn_features.restype = _I
    lib.host_dfn_spec_synth.argtypes = (_P,) * 5 + (ctypes.c_float, ctypes.c_float, _P, _I)
    lib.host_dfn_spec_synth.restype = _I
    lib.host_env_scan.argtypes = (_P,) * 4 + (_I, _I)
    lib.host_env_scan.restype = _I
    lib.host_quotient_mismatches.argtypes = (_I, _I)
    lib.host_quotient_mismatches.restype = ctypes.c_longlong
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _cascade_inputs(S: int, seed: int):
    """A block and a cascade of S sections per stream: stream 0 has every
    section's crossfade ending mid-block (at t = 40), stream 1 is idle,
    stream 2 fades on even sections past the block's end."""
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((N, T))).astype(np.float32)
    freqs = np.geomspace(60.0, 12000.0, S)
    kinds = [tbq.HIGH_PASS if S <= 2 and s == 0 else tbq.PEAKING for s in range(S)]
    old = np.stack([tbq.design(k, f, g, 2.0, FS) for k, f, g
                    in zip(kinds, freqs, rng.uniform(-4, 4, S))])
    new = np.stack([tbq.design(k, f * 1.2, g, 1.5, FS) for k, f, g
                    in zip(kinds, freqs, rng.uniform(-4, 4, S))])
    coeffs = np.empty((N, S, 2, 5), np.float32)
    coeffs[:, :, 0] = old
    coeffs[:, :, 1] = new
    z = (0.05 * rng.standard_normal((N, S, 2, 2))).astype(np.float64)
    total = np.zeros((N, S), np.int32)
    remaining = np.zeros((N, S), np.int32)
    total[0], remaining[0] = 72, 40
    total[2, ::2], remaining[2, ::2] = 700, 650
    idle = remaining == 0
    coeffs[idle, 1] = coeffs[idle, 0]  # idle lanes are identical
    z[idle, 1] = z[idle, 0]
    return x, coeffs, z, total, remaining


@pytest.mark.parametrize("tc", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("S", [1, 2, 10])
def test_biquad_cascade_host_build_matches_plain(host_lib, S, tc):
    x, coeffs, z, total, remaining = _cascade_inputs(S, seed=40 + S)
    y = np.empty_like(x)
    z_out = np.empty_like(z)
    err = host_lib.host_biquad_cascade(
        _ptr(x), _ptr(coeffs), _ptr(z), _ptr(total), _ptr(remaining), _ptr(y),
        _ptr(z_out), N, S, T, tc)
    assert err == 0
    yp, zp = tbq.biquad_cascade_plain(*(torch.from_numpy(a) for a in
                                        (x, coeffs, z, total, remaining)))
    np.testing.assert_allclose(y, yp.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(z_out, zp.numpy(), rtol=0, atol=1e-6)
    if S > 1:  # the crossfade changed stream 0's output against idle lanes
        idle = dict(zip(("x", "coeffs", "z", "total", "remaining"),
                        (torch.from_numpy(a) for a in (x, coeffs, z, total, remaining))))
        idle["remaining"] = torch.zeros_like(idle["remaining"])
        y_idle, _ = tbq.biquad_cascade_plain(*idle.values())
        assert np.abs(y[0] - y_idle[0].numpy()).max() > 1e-3


def test_crossfade_weight_equals_the_division(host_lib):
    """The kernel's crossfade weight (reciprocal and FMA correction) is the
    correctly rounded quotient the plain twin's division gives, bit for bit,
    for every crossfade length a unit schedules and 4096 samples past it."""
    longest = tbq.MAX_COEFF_CROSSFADE_SAMPLES
    assert host_lib.host_quotient_mismatches(longest, 4096) == 0


def _sibilant(n_blocks: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / FS
    body = 0.05 * np.sin(2 * np.pi * rng.uniform(120.0, 220.0, (N, 1)) * t)
    sib = 0.25 * np.sin(2 * np.pi * 6800.0 * t) * (
        np.sin(2 * np.pi * rng.uniform(3.0, 6.0, (N, 1)) * t) > -0.5)
    x = body + sib + 0.002 * rng.standard_normal((N, t.size))
    x[2] = body[2]  # one stream without sibilance
    return x.astype(np.float32)


@pytest.mark.parametrize("tc", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("auto", [True, False], ids=["auto", "manual"])
def test_deesser_scan_host_build_matches_plain(host_lib, auto, tc):
    cfg = tdes.DeEsserConfig(enabled=True, auto_enabled=auto, threshold_db=-40.0)
    x = _sibilant(3, seed=80 + auto)
    state = tdes.deesser_init(cfg, n=N, device="cpu")
    for b in range(2):  # warm the envelopes so the reduction is engaged
        state, _ = tdes.deesser_scan_plain(cfg, state, torch.from_numpy(x[:, b * T:(b + 1) * T]))
    xb = np.ascontiguousarray(x[:, 2 * T:])
    s_in = tdes.pack_scan_state(state).numpy()
    consts = tdes._consts(cfg)
    y = np.empty_like(xb)
    s_out = np.empty_like(s_in)
    err = host_lib.host_deesser_scan(_ptr(xb), _ptr(s_in), _ptr(y), _ptr(s_out), N, T,
                                     _ptr(consts), consts.size, int(auto), tc)
    assert err == 0
    sp, yp = tdes.deesser_scan_plain(cfg, state, torch.from_numpy(xb))
    np.testing.assert_allclose(y, yp.numpy(), rtol=0, atol=1e-4)
    sk = tdes.unpack_scan_state(torch.from_numpy(s_out), state)
    for key, ref in sp.items():
        np.testing.assert_allclose(sk[key].numpy(), ref.numpy(), rtol=0, atol=1e-3,
                                   err_msg=key)
    red = sp["current_reduction_db"].numpy()
    assert red[:2].min() > 0.1 and red[2] < red[:2].min()  # sibilance engaged it


# ---------------------------------------------------------------------------
# compressor_scan and gate_scan: N streams over two of the kernel's blocks
# ---------------------------------------------------------------------------

NS = 11
COMP_BLOCKS = 3
GATE_BLOCKS = {tgate.THRESHOLD_ONLY: 24, tgate.VAD_ASSISTED: 12, tgate.VAD_ONLY: 12}
# stream-blocks (of NS x blocks) that may part from the twin: an ulp between
# libm's and torch's log10f at a >= threshold test flips a decision
GATE_APART_MAX = 2


def _bursts(n_blocks: int, seed: int, rate_hz=(3.0, 6.0)) -> np.ndarray:
    """Voiced bursts with per-stream level over a noise floor, ``[NS, n_blocks * T]``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * T) / FS
    on = np.sin(2 * np.pi * rng.uniform(*rate_hz, (NS, 1)) * t
                + rng.uniform(0, 6, (NS, 1))) > 0.2
    f0 = rng.uniform(110.0, 240.0, (NS, 1))
    voice = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 5))
    x = rng.uniform(0.1, 0.6, (NS, 1)) * on * voice + 0.002 * rng.standard_normal((NS, t.size))
    x[:, T - 200:T] += 0.8 * np.hanning(400)[:200]  # a low thump up to the first block's end
    return x.astype(np.float32)


COMP_FLAGS = {
    "sidechain": {"sidechain_highpass_enabled": True},
    "sidechain+adaptive": {"sidechain_highpass_enabled": True, "adaptive_release": True},
    "neither": {},
}


@functools.lru_cache(maxsize=None)
def _compressor_twin(flags: str):
    """The twin over COMP_BLOCKS blocks: inputs and its state and output per block."""
    cfg = tcomp.CompressorConfig(**COMP_FLAGS[flags])
    rng = np.random.default_rng(31)
    x = _bursts(COMP_BLOCKS, seed=30)
    params = {k: torch.full((NS,), float(np.float32(v))) for k, v in
              tcomp.compressor_params(cfg, attack_ms=4.0, release_ms=120.0).items()}
    params["threshold_db"] = torch.tensor(rng.uniform(-40, -22, NS).astype(np.float32))
    params["ratio"] = torch.tensor(rng.uniform(2, 8, NS).astype(np.float32))
    params["knee_db"] = torch.tensor(np.where(np.arange(NS) % 2, 6.0, 0.0).astype(np.float32))
    makeup = torch.tensor(rng.uniform(0.8, 1.5, NS).astype(np.float32))
    s0 = tcomp.compressor_init(cfg, n=NS, device="cpu")
    state = {k: s0[k] for k in tcomp.SCAN_STATE_KEYS}
    outs, s = [], state
    for b in range(COMP_BLOCKS):
        s, y = tcomp.compressor_scan_plain(cfg, params, makeup, s,
                                           torch.from_numpy(x[:, b * T:(b + 1) * T]))
        outs.append(({k: v.numpy() for k, v in s.items()}, y.numpy()))
    return cfg, x, params, makeup, state, outs


@pytest.mark.parametrize("tc", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("flags", list(COMP_FLAGS))
def test_compressor_scan_host_build_matches_plain(host_lib, flags, tc):
    cfg, x, params, makeup, state, outs = _compressor_twin(flags)
    p = np.stack([params[k].numpy() for k in tcomp.SCAN_PARAM_KEYS] + [makeup.numpy()])
    k = tcomp._scan_consts(cfg)
    consts = np.array([k["rms_c"], k["band_c"], k["rel_smooth_c"], k["fast_c"],
                       k["charge_c"], k["slow_c"], cfg.sample_rate], np.float32)
    s_in = np.stack([state[key].numpy() for key in tcomp.SCAN_STATE_KEYS])
    engaged = 0.0
    for b, (sp, yp) in enumerate(outs):
        xb = np.ascontiguousarray(x[:, b * T:(b + 1) * T])
        y, s_out = np.empty_like(xb), np.empty_like(s_in)
        err = host_lib.host_compressor_scan(
            _ptr(xb), _ptr(p), _ptr(s_in), _ptr(y), _ptr(s_out), NS, T, _ptr(consts),
            int(cfg.adaptive_release), int(cfg.sidechain_highpass_enabled), tc)
        assert err == 0
        np.testing.assert_allclose(y, yp, rtol=0, atol=1e-5, err_msg=f"block {b}")
        sk = dict(zip(tcomp.SCAN_STATE_KEYS, s_out))
        for key, ref in sp.items():
            np.testing.assert_allclose(sk[key], ref, rtol=0, atol=1e-3,
                                       err_msg=f"{key}, block {b}")
        engaged = max(engaged, float(sp["current_gr_db"].max()))
        s_in = s_out  # the next block from the host build's own state
    assert engaged > 3.0  # the bursts drove the gain reduction
    if cfg.sidechain_highpass_enabled:
        assert outs[0][0]["plosive_ratio"].max() > 1.25  # the thump weighs on the detector


GATE_MODES = {"threshold-only": tgate.THRESHOLD_ONLY, "vad-assisted": tgate.VAD_ASSISTED,
              "vad-only": tgate.VAD_ONLY}


@functools.lru_cache(maxsize=None)
def _gate_twin(mode: int):
    """The twin over the mode's blocks: inputs and its state and output per block.
    The gate closes between short bursts, and the VAD inputs jump per block,
    so hold, chatter and (VAD modes) auto-relax engage."""
    n_blocks = GATE_BLOCKS[mode]
    cfg = tgate.GateConfig(mode=mode)
    rng = np.random.default_rng(41)
    # 10 ms bursts every 100-120 ms: open through the detector's decay and the
    # 50 ms hold, then closed until the next burst
    t = np.arange(n_blocks * T) / FS
    on = np.mod(t + rng.uniform(0, 0.1, (NS, 1)), rng.uniform(0.100, 0.120, (NS, 1))) < 0.010
    x = (0.2 * on * np.sin(2 * np.pi * 180.0 * t)
         + 0.002 * rng.standard_normal((NS, t.size))).astype(np.float32)
    params = {k: torch.full((NS,), float(np.float32(v))) for k, v in
              tgate.gate_params(cfg, attack_ms=5.0, release_ms=60.0).items()}
    params["threshold_db"] = torch.tensor(rng.uniform(-45, -25, NS).astype(np.float32))
    vads = []
    for _ in range(n_blocks):
        prob = np.where(rng.random(NS) > 0.5, rng.uniform(0.7, 1.0, NS),
                        rng.uniform(0.0, 0.3, NS)).astype(np.float32)
        vads.append((torch.from_numpy(prob), torch.from_numpy(rng.random(NS) > 0.2),
                     torch.from_numpy(rng.random(NS) > 0.5), torch.full((NS,), 0.48)))
    # a state from mid-stream: two transitions into a chatter window
    state = dict(tgate.gate_init(n=NS, device="cpu"),
                 has_effective_gate_state=torch.ones(NS, dtype=torch.bool),
                 chatter_transition_count=torch.full((NS,), 2, dtype=torch.int32),
                 chatter_window_remaining=torch.full((NS,), 23000, dtype=torch.int32))
    outs, s = [], state
    for b in range(n_blocks):
        s, y, _ = tgate.gate_process_plain(cfg, s, torch.from_numpy(x[:, b * T:(b + 1) * T]),
                                           *vads[b], params)
        outs.append(({k: v.numpy() for k, v in s.items()}, y.numpy()))
    return cfg, x, params, vads, state, outs


@pytest.mark.parametrize("tc", CHUNKS, ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("mode", list(GATE_MODES))
def test_gate_scan_host_build_matches_plain(host_lib, mode, tc):
    cfg, x, params, vads, state, outs = _gate_twin(GATE_MODES[mode])
    p = np.stack([params[k].numpy() for k in tgate.PARAM_KEYS])
    consts = tgate._scan_consts(cfg)
    fconsts = np.array(consts[:4], np.float32)
    iconsts = np.array(consts[4:], np.int32)
    fs_in = np.stack([state[k].numpy() for k in tgate.FLOAT_KEYS])
    is_in = np.stack([state[k].numpy().astype(np.int32) for k in tgate.INT_KEYS])
    apart_blocks, worst = 0, 0.0
    for b, (sp, yp) in enumerate(outs):
        xb = np.ascontiguousarray(x[:, b * T:(b + 1) * T])
        vad = np.stack([v.numpy().astype(np.float32) for v in vads[b]])
        y, fs_out, is_out = np.empty_like(xb), np.empty_like(fs_in), np.empty_like(is_in)
        err = host_lib.host_gate_scan(
            _ptr(xb), _ptr(p), _ptr(vad), _ptr(fs_in), _ptr(is_in), _ptr(y), _ptr(fs_out),
            _ptr(is_out), NS, T, cfg.mode, _ptr(fconsts), _ptr(iconsts), tc)
        assert err == 0
        stream_err = np.abs(y - yp).max(axis=1)
        apart = stream_err > 1e-4
        for key, row in zip(tgate.INT_KEYS, is_out):
            apart |= row != sp[key].astype(np.int32)
        apart_blocks += int(apart.sum())
        worst = max(worst, float(np.where(apart, 0.0, stream_err).max()))
        if not apart.any():  # the float state too, where nothing flipped
            for key, row in zip(tgate.FLOAT_KEYS, fs_out):
                np.testing.assert_allclose(row, sp[key], rtol=0, atol=1e-3,
                                           err_msg=f"{key}, block {b}")
        fs_in, is_in = fs_out, is_out  # the next block from the host build's own state
    assert apart_blocks <= GATE_APART_MAX, f"{apart_blocks} stream-blocks apart"
    assert worst <= 1e-4
    last = outs[-1][0]
    assert last["chatter_event_count"].max() > 0  # chatter fired
    assert max(o[0]["hold_remaining"].max() for o in outs) > 0
    if cfg.mode != tgate.THRESHOLD_ONLY:
        assert max(o[0]["auto_relax_remaining"].max() for o in outs) > 0


# ---------------------------------------------------------------------------
# cleanup_scan, max_affine_scan and limiter_gain_scan
# ---------------------------------------------------------------------------

# (block length, chunk): 0 is the chunk the kernel's launcher picks, which
# holds 480 samples whole and splits 960 in two
SHAPES = {"480": (480, 0), "960-two-chunks": (960, 0), "480-chunk128": (480, 128)}
CLEANUP_MODES = {"gentle": troute.CLEANUP_GENTLE, "strong": troute.CLEANUP_STRONG}
# streams of _cleanup_inputs on which the rumble trigger fires; on the others
# a hum hold, a hum candidate or a quiet low band keeps it from firing
FIRING = (0, 1, 2, 5, 8, 9)


def _cleanup_inputs(mode: int, T_block: int, seed: int):
    """``(cfg, state, ctx, x)`` for ``cleanup_scan_plain`` over NS streams
    from mid-stream: a voice over hum, with a 45 Hz thump on most streams.
    The window's boundary lies inside the block. Crossfades: streams 0-3
    mixed (hum fading on 0 and 2, harmonic on 1 and 2), 4-7 idle (a warp of
    the kernel without a fade), 8-10 fading on both notches with different
    progress. The trigger can fire before the boundary only (1), after it
    only (2), anywhere (0, 5, 8, 9); it is held off by a hum hold (3), a hum
    candidate (4), too quiet a low band (6, 10) or a fresh detector whose
    start-up level is not reached (7)."""
    rng = np.random.default_rng(seed)
    cfg = troute.RoutingConfig(cleanup_mode=mode)
    fade_total = cfg.notch_fade_samples
    t = np.arange(T_block) / FS
    level = np.ones((NS, 1))
    level[[6, 10]] = 0.0             # no thump
    level[7] = 0.4                   # a thump under the start-up level
    x = (0.08 * np.sin(2 * np.pi * rng.uniform(180, 220, (NS, 1)) * t)
         + 0.02 * np.sin(2 * np.pi * 50.4 * t + rng.uniform(0, 6, (NS, 1)))
         + 0.003 * rng.standard_normal((NS, t.size)))
    x[[6, 10]] *= 0.1
    x += level * 0.7 * np.sin(2 * np.pi * 45.0 * t) * np.minimum(1.0, np.arange(T_block) / 100.0)
    x = torch.from_numpy(x.astype(np.float32))

    i32 = lambda v: torch.tensor(np.broadcast_to(v, (NS,)).copy(), dtype=torch.int32)
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32))
    boundary = 200
    hold0 = np.zeros(NS, np.int64)
    hold_after = np.zeros(NS, np.int64)
    cand0 = np.zeros(NS, np.int64)
    cand_new = np.zeros(NS, np.int64)
    hold_after[1] = 30000            # fires before the boundary only
    hold0[2] = boundary - 40         # runs out before the boundary; a candidate until it
    cand0[2] = 1
    hold0[3], hold_after[3] = 30000, 30000
    cand0[4], cand_new[4] = 1, 2
    wobs0 = np.full(NS, 3)
    wobs0[7] = 0                     # start-up: needs low > 0.45
    ctx = {"boundary": i32(boundary), "hold0": i32(hold0), "hold_after": i32(hold_after),
           "cand0": i32(cand0), "cand_new": i32(cand_new), "wobs0": i32(wobs0),
           "wobs_new": i32(wobs0 + 1)}
    ctx["wobs_new"][7] = 0

    line = torch.full((NS,), 50.4)
    state = {
        "lowpass_state": f32(rng.uniform(-0.05, 0.05, NS)),
        "low_env": f32(rng.uniform(0.0, 0.03, NS)),
        "slow_low_env": f32(rng.uniform(0.013, 0.02, NS)),
        "broadband_env": f32(rng.uniform(0.01, 0.05, NS)),
        "dc_x1": f32(rng.uniform(-0.1, 0.1, NS)),
        "dc_y1": f32(rng.uniform(-0.1, 0.1, NS)),
        "rumble_hold": i32(rng.integers(0, 3) + np.where(np.arange(NS) % 2, 2000, 100)),
        "hum_strength": f32(rng.uniform(0.2, 0.9, NS)),
        "harmonic_strength": f32(rng.uniform(0.0, 0.6, NS)),
    }
    state["low_env"][7] = 0.0
    state["lowpass_state"][[6, 10]] *= 0.1
    fading = {"hum_notch": (0, 2, 8, 9, 10), "harmonic_notch": (1, 2, 8, 9, 10)}
    for key, mult in (("hum_notch", 1.0), ("harmonic_notch", 2.0)):
        notch = troute._smooth_notch_init(55.0 * mult, FS, NS, "cpu")
        notch["z"] = torch.from_numpy(1e-2 * rng.standard_normal((NS, 2, 2)))
        notch["z"][:, 1] = notch["z"][:, 0]
        on = torch.zeros(NS, dtype=torch.bool)
        on[list(fading[key])] = True
        target = torch.where(on, line * mult, notch["pending_freq"])
        notch = troute._smooth_notch_retune(notch, target, FS, fade_total)
        # crossfades at different progress: ending in the block, in its
        # second half (960) and after it
        left = torch.tensor(rng.integers(1, fade_total + 1, NS), dtype=torch.int32)
        left[8], left[9] = 150, 700
        notch["fade_remaining"] = torch.where(on, left, 0).to(torch.int32)
        notch["z"][:, 1] = torch.where(on[:, None], 1e-3, notch["z"][:, 1])
        state[key] = notch
    return cfg, state, ctx, x


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", list(CLEANUP_MODES))
def test_cleanup_scan_host_build_matches_plain(host_lib, mode, shape):
    T_block, tc = SHAPES[shape]
    cfg, state, ctx, x = _cleanup_inputs(CLEANUP_MODES[mode], T_block, seed=60)
    op, yp = troute.cleanup_scan_plain(cfg, state, ctx, x)

    fin = np.stack([state[k].numpy() for k in troute._SCAN_FLOAT_KEYS])
    iin = np.stack([state["rumble_hold"].numpy()]
                   + [ctx[k].numpy() for k in troute._SCAN_INT_KEYS[1:8]]
                   + [state[k]["fade_remaining"].numpy() for k in troute._NOTCHES]
                   ).astype(np.int32)
    leaves = [np.ascontiguousarray(state[k][leaf].numpy())
              for leaf in ("coeffs", "z") for k in troute._NOTCHES]
    consts = troute._scan_consts(cfg)
    fconsts = np.array(consts[:3], np.float32)
    iconsts = np.array(consts[3:5], np.int32)
    xb = np.ascontiguousarray(x.numpy())
    y = np.empty_like(xb)
    fout = np.empty((6, NS), np.float32)
    zout = [np.empty((NS, 2, 2), np.float64) for _ in troute._NOTCHES]
    iout = np.empty((1, NS), np.int32)
    err = host_lib.host_cleanup_scan(
        _ptr(xb), _ptr(fin), *(_ptr(a) for a in leaves), _ptr(iin), _ptr(y), _ptr(fout),
        *(_ptr(z) for z in zout), _ptr(iout), NS, T_block, _ptr(fconsts), _ptr(iconsts),
        consts[5], tc)
    assert err == 0
    np.testing.assert_allclose(y, yp.numpy(), rtol=0, atol=1e-6)
    for key, z in zip(troute._NOTCHES, zout):
        np.testing.assert_allclose(z, op[key].numpy(), rtol=0, atol=1e-9, err_msg=key)
    out = dict(zip(troute._SCAN_FLOAT_KEYS, fout))
    for key in troute._SCAN_FLOAT_KEYS[:4]:  # the rumble detector rounds as the twin
        np.testing.assert_array_equal(out[key], op[key].numpy(), err_msg=key)
    for key in ("dc_x1", "dc_y1"):
        np.testing.assert_allclose(out[key], op[key].numpy(), rtol=0, atol=1e-6, err_msg=key)
    hold = op["rumble_hold"].numpy()
    np.testing.assert_array_equal(iout[0], hold)
    # the trigger fired where it could and nowhere else: a fired hold stands
    # within a block of its set value, the others ran down from their start
    hold_set = consts[3]
    fired = hold > hold_set - T_block
    assert sorted(np.flatnonzero(fired)) == sorted(FIRING)
    start = state["rumble_hold"].numpy()
    np.testing.assert_array_equal(hold[~fired], np.maximum(start[~fired] - T_block, 0))
    assert hold[1] == hold_set - (T_block - 200)  # last fired just before the boundary
    # the crossfades changed the output: against the same state with idle lanes
    idle = dict(state)
    for key in troute._NOTCHES:
        idle[key] = dict(state[key], fade_remaining=torch.zeros(NS, dtype=torch.int32))
    _, y_idle = troute.cleanup_scan_plain(cfg, idle, ctx, x)
    assert (yp[8] - y_idle[8]).abs().max() > 1e-4


def _limiter_inputs(kind: str, T_block: int, seed: int):
    """``(peak, xd, ceiling, rc, gain0, scale)`` as the lookahead limiter
    (window max of the history-extended block, both arguments windows of
    longer rows) or the true-peak limiter (a contiguous peak, the delayed
    input a window) gives them; transients over the ceiling on most streams,
    none on stream 3, a gain still releasing from the block before on the
    odd streams."""
    rng = np.random.default_rng(seed)
    W = 96 if kind == "limiter" else 20
    ext = 0.4 * rng.standard_normal((NS, W + T_block))
    for i in range(NS):
        for at in rng.integers(0, W + T_block - 40, 3):
            ext[i, at:at + 30] *= rng.uniform(2.0, 4.0)
    ext[3] = np.clip(ext[3], -0.5, 0.5)
    ext = torch.from_numpy(ext.astype(np.float32))
    if kind == "limiter":
        peak = tscan.sliding_window_max(ext.abs(), W + 1)[:, W:]
        scale, release_s = 1.0, 0.050
    else:
        peak = (ext[:, W:].abs() * torch.from_numpy(
            rng.uniform(1.0, 1.2, (NS, T_block)).astype(np.float32))).contiguous()
        scale, release_s = 0.999, 0.020
    ceiling = torch.from_numpy(rng.uniform(0.7, 0.95, NS).astype(np.float32))
    rc = torch.full((NS,), float(np.exp(-1.0 / (release_s * FS))))
    gain0 = torch.from_numpy(
        np.where(np.arange(NS) % 2, rng.uniform(0.4, 0.9, NS), 1.0).astype(np.float32))
    return peak, ext[:, :T_block], ceiling, rc, gain0, scale


@pytest.mark.parametrize("shape", list(SHAPES))
def test_max_affine_scan_host_build_matches_plain(host_lib, shape):
    T_block, tc = SHAPES[shape]
    peak, _, ceiling, rc, gain0, _ = _limiter_inputs("limiter", T_block, seed=70)
    target = torch.where(peak > ceiling[:, None], ceiling[:, None] / peak, 1.0)
    v = (1.0 - target).contiguous()
    c = ((1.0 - rc)[:, None] * v).contiguous()
    u0 = (1.0 - gain0).contiguous()
    u = np.empty((NS, T_block), np.float32)
    err = host_lib.host_max_affine_scan(_ptr(v.numpy()), _ptr(c.numpy()), _ptr(rc.numpy()),
                                        _ptr(u0.numpy()), _ptr(u), NS, T_block, tc)
    assert err == 0
    up = tscan.max_affine_scan_plain(v, rc, c, u0).numpy()
    np.testing.assert_array_equal(u, up)
    # limiting engaged; stream 3 only releases from the block before
    assert up.max() > 0.3 and (np.diff(up[3]) <= 0).all() and (np.diff(up[0]) > 0).any()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["limiter", "true-peak"])
def test_limiter_gain_scan_host_build_matches_plain(host_lib, kind, shape):
    T_block, tc = SHAPES[shape]
    peak, xd, ceiling, rc, gain0, scale = _limiter_inputs(kind, T_block, seed=71)
    assert not xd.is_contiguous() and (kind == "true-peak") == peak.is_contiguous()
    y = np.empty((NS, T_block), np.float32)
    gain_last, min_gain = np.empty(NS, np.float32), np.empty(NS, np.float32)
    events = np.empty(NS, np.int32)
    err = host_lib.host_limiter_gain_scan(
        peak.data_ptr(), peak.stride(0), xd.data_ptr(), xd.stride(0), _ptr(ceiling.numpy()),
        _ptr(rc.numpy()), _ptr(gain0.numpy()), scale, _ptr(y), _ptr(gain_last),
        _ptr(min_gain), _ptr(events), NS, T_block, tc)
    assert err == 0
    yp, lastp, minp, eventsp = tscan.limiter_gain_scan_plain(peak, xd, ceiling, rc, gain0, scale)
    np.testing.assert_array_equal(y, yp.numpy())
    np.testing.assert_array_equal(gain_last, lastp.numpy())
    np.testing.assert_array_equal(min_gain, minp.numpy())
    np.testing.assert_array_equal(events, eventsp.numpy())
    assert eventsp.numpy().sum() >= NS - 2 and minp.min() < 0.5  # limiting engaged
    assert np.abs(yp.numpy()).max(axis=1).max() <= ceiling.max()


# ---------------------------------------------------------------------------
# The model kernels of the serving step: vad_front, vad_lstm_head (Silero),
# dfn_features, dfn_spec_synth (DeepFilterNet3)
# ---------------------------------------------------------------------------

NM = 11  # streams: one block of the kernels' eight and a ragged second


def test_vad_front_taps_equal_the_design(host_lib):
    taps = np.array([host_lib.afk_vad_front_tap(t) for t in range(tres.VAD_DECIMATE_TAPS)],
                    np.float32)
    np.testing.assert_array_equal(taps, tres.decimate3_taps())


@pytest.mark.parametrize("gain", [1.0, 2.5])
def test_vad_front_host_build_matches_plain(host_lib, gain):
    """Two consecutive blocks, the second from the first's history and
    window. Decimated samples 1e-6 (a 31-tap f32 sum in another order), the
    rest exact."""
    rng = np.random.default_rng(90)
    hist = np.zeros((NM, 30), np.float32)
    window = (0.2 * rng.standard_normal((NM, 576))).astype(np.float32)
    for b in range(2):
        x = (0.3 * rng.standard_normal((NM, 480))).astype(np.float32)
        h_out, w_out = np.empty_like(hist), np.empty_like(window)
        frames = np.empty((NM * 4, 256), np.float32)
        assert host_lib.host_vad_front(_ptr(x), _ptr(hist), _ptr(window), gain, _ptr(h_out),
                                       _ptr(w_out), _ptr(frames), NM) == 0
        hp, wp, fp = tsil.vad_front_plain(torch.as_tensor(x), torch.as_tensor(hist),
                                          torch.as_tensor(window), gain)
        np.testing.assert_array_equal(h_out, hp.numpy())
        np.testing.assert_allclose(w_out, wp.numpy(), atol=1e-6)
        np.testing.assert_array_equal(w_out[:, :416], window[:, 160:])
        np.testing.assert_allclose(frames, fp.numpy(), atol=1e-6 * gain)
        hist, window = h_out, w_out


@pytest.mark.parametrize("smoothing", [0.5, 0.2])
def test_vad_lstm_head_host_build_matches_plain(host_lib, smoothing):
    """Streams before, at and after the warm-up (blocks seen 0-6), a NaN
    smoothed value on one warm stream. The state 1e-6, the probability and
    the EMA 1e-5 (the head's dot in the kernel's order: a butterfly on each
    warp, the warps' parts added in warp order), counts and flags exact."""
    rng = np.random.default_rng(91)
    p = {k: torch.as_tensor(v) for k, v in tsil.init_params().items()}
    p["lstm_bi"] = torch.as_tensor(rng.normal(0, 0.3, 512).astype(np.float32))
    p["lstm_bh"] = torch.as_tensor(rng.normal(0, 0.3, 512).astype(np.float32))
    p["head_b"] = torch.tensor([0.4])
    gates = (1.5 * rng.standard_normal((NM, 512))).astype(np.float32)
    lstm = rng.normal(0, 0.5, (NM, 2, 128)).astype(np.float32)
    smoothed = rng.uniform(0, 1, NM).astype(np.float32)
    smoothed[5] = np.nan  # warm and past the first warm block: the EMA reads it
    seen = (np.arange(NM) % 7).astype(np.int32)
    out = dict(lstm=np.empty_like(lstm), smoothed=np.empty_like(smoothed),
               seen=np.empty_like(seen), prob=np.empty_like(smoothed),
               avail=np.empty(NM, bool))
    assert host_lib.host_vad_lstm_head(
        _ptr(gates), _ptr(lstm), _ptr(p["lstm_bi"].numpy()), _ptr(p["lstm_bh"].numpy()),
        _ptr(p["head_w"].numpy()), 0.4, _ptr(smoothed), _ptr(seen), smoothing,
        _ptr(out["lstm"]), _ptr(out["smoothed"]), _ptr(out["seen"]), _ptr(out["prob"]),
        _ptr(out["avail"]), NM, tsil.VAD_WARMUP_BLOCKS) == 0
    lp, sp, seen_p, pp, ap = tsil.vad_lstm_head_plain(
        p, torch.as_tensor(gates), torch.as_tensor(lstm), torch.as_tensor(smoothed),
        torch.as_tensor(seen), smoothing)
    np.testing.assert_allclose(out["lstm"], lp.numpy(), atol=1e-6)
    np.testing.assert_allclose(out["smoothed"], sp.numpy(), atol=1e-5)
    np.testing.assert_allclose(out["prob"], pp.numpy(), atol=1e-5)
    np.testing.assert_array_equal(out["seen"], seen_p.numpy())
    np.testing.assert_array_equal(out["avail"], ap.numpy())
    assert out["avail"].sum() == (seen >= 3).sum() and out["prob"][5] == 0.0


@pytest.mark.parametrize("T_block", [480, 1000])
@pytest.mark.parametrize("B", [16, 17, 1])
def test_env_scan_host_build_matches_plain(host_lib, B, T_block):
    """The kernel's chunk schedule over its ring of tiles: T = 480 (a last
    chunk that is not whole) and 1000 (more chunks than the ring holds); B
    a whole strip, a strip and one column, one column. Two consecutive
    blocks, the second from the first's envelope. y 1e-5 (libm's logf
    against torch's log), the envelope 1e-6 relative (an FMA against the
    twin's rounded product and sum)."""
    rng = np.random.default_rng(93)
    env = rng.uniform(0, 1, B).astype(np.float32)
    for _ in range(2):
        x = rng.standard_normal((T_block, B)).astype(np.float32)
        x[T_block // 3] = 0.0  # env decays towards 0 over a silent row
        y, env_out = np.empty_like(x), np.empty_like(env)
        assert host_lib.host_env_scan(_ptr(x), _ptr(env), _ptr(y), _ptr(env_out),
                                      T_block, B) == 0
        yp, ep = tenv.env_scan_plain(torch.as_tensor(x), torch.as_tensor(env))
        np.testing.assert_allclose(y, yp.numpy(), atol=1e-5)
        np.testing.assert_allclose(env_out, ep.numpy(), rtol=1e-6)
        env = env_out


@pytest.mark.parametrize("level", [1e-3, 1.0, 30.0])
def test_dfn_features_host_build_matches_plain(host_lib, level):
    """Spectra at three levels, an empty band on one stream. Norms 1e-6
    relative, features 1e-4 (dB of a band sum in another order, over 40)."""
    rng = np.random.default_rng(92)
    spec = (level * rng.standard_normal((NM, 481, 2))).astype(np.float32)
    spec[4, :40] = 0.0
    erb_norm = rng.uniform(-90, -20, (NM, 32)).astype(np.float32)
    unit_norm = rng.uniform(1e-4, 1.0, (NM, 96)).astype(np.float32)
    offsets = tdfn._consts(torch.device("cpu"))["erb_offsets"].numpy()
    got = dict(feat_erb=np.empty_like(erb_norm), feat_spec=np.empty((NM, 2, 96), np.float32),
               erb=np.empty_like(erb_norm), unit=np.empty_like(unit_norm))
    assert host_lib.host_dfn_features(
        _ptr(spec), _ptr(erb_norm), _ptr(unit_norm), _ptr(offsets), _ptr(got["feat_erb"]),
        _ptr(got["feat_spec"]), _ptr(got["erb"]), _ptr(got["unit"]), NM, tdfn._NORM_ALPHA,
        1.0 - tdfn._NORM_ALPHA) == 0
    fe, fs, en, un = tdfn.dfn_features_plain(torch.as_tensor(spec), torch.as_tensor(erb_norm),
                                             torch.as_tensor(unit_norm))
    np.testing.assert_allclose(got["feat_erb"], fe.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["erb"], en.numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["unit"], un.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["feat_spec"], fs.numpy(), rtol=1e-5, atol=1e-5)


def test_dfn_features_host_build_band_split(host_lib):
    """The band sums as the kernel splits them over its warps, on the bands
    the split reorders most and a band with nothing in it: stream 0 carries
    power only in the 67-bin top band (levels over six decades, so the
    order of its 17-term parts shows), stream 1 has band 20 (bins 80-92)
    and every band below 4 zero, stream 2 is zero everywhere. The zero
    bands read the floor, 10 log10(1e-10) = -100 dB; feat_erb 1e-4, norms 1e-6 relative (dB of a band sum in another order,
    over 40)."""
    rng = np.random.default_rng(94)
    offsets = tdfn._consts(torch.device("cpu"))["erb_offsets"].numpy()
    top = slice(offsets[31], offsets[32])
    assert offsets[32] - offsets[31] == 67
    spec = np.zeros((3, 481, 2), np.float32)
    spec[0, top] = (10.0 ** rng.uniform(-3, 3, (67, 1))
                    * rng.standard_normal((67, 2))).astype(np.float32)
    spec[1] = rng.standard_normal((481, 2)).astype(np.float32)
    spec[1, offsets[20]:offsets[21]] = 0.0
    spec[1, :offsets[4]] = 0.0
    erb_norm = rng.uniform(-90, -20, (3, 32)).astype(np.float32)
    unit_norm = rng.uniform(1e-4, 1.0, (3, 96)).astype(np.float32)
    got = dict(feat_erb=np.empty_like(erb_norm), feat_spec=np.empty((3, 2, 96), np.float32),
               erb=np.empty_like(erb_norm), unit=np.empty_like(unit_norm))
    assert host_lib.host_dfn_features(
        _ptr(spec), _ptr(erb_norm), _ptr(unit_norm), _ptr(offsets), _ptr(got["feat_erb"]),
        _ptr(got["feat_spec"]), _ptr(got["erb"]), _ptr(got["unit"]), 3, tdfn._NORM_ALPHA,
        1.0 - tdfn._NORM_ALPHA) == 0
    fe, fs, en, un = tdfn.dfn_features_plain(torch.as_tensor(spec), torch.as_tensor(erb_norm),
                                             torch.as_tensor(unit_norm))
    np.testing.assert_allclose(got["feat_erb"], fe.numpy(), atol=1e-4)
    np.testing.assert_allclose(got["erb"], en.numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got["unit"], un.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["feat_spec"], fs.numpy(), rtol=1e-5, atol=1e-5)
    # a band's dB from its feature: feat = alpha (db - norm_in) / 40; the
    # zero bands sit at the floor, the top band of stream 0 well above it
    db = 40.0 * got["feat_erb"].astype(np.float64) / tdfn._NORM_ALPHA + erb_norm
    zero = [(0, b) for b in range(31)] + [(1, 20), (1, 0), (1, 3)] + [(2, b) for b in range(32)]
    np.testing.assert_allclose([db[n, b] for n, b in zero], -100.0, atol=1e-3)
    assert db[0, 31] > 0.0


@pytest.mark.parametrize("atten,beta", [(30.0, 0.0), (6.0, 0.03), (100.0, 0.05)])
def test_dfn_spec_synth_host_build_matches_plain(host_lib, atten, beta):
    """Gains over [0, 1] (and 0 and 1 exactly), random taps and history:
    the spectrum 1e-6 relative to its scale (a five-tap complex sum)."""
    rng = np.random.default_rng(93)
    x = rng.standard_normal((NM, 481, 2)).astype(np.float32)
    gains = rng.uniform(0, 1, (NM, 32)).astype(np.float32)
    gains[0, :2] = (0.0, 1.0)
    coefs = rng.normal(0, 0.5, (NM, 5, 96, 2)).astype(np.float32)
    hist = rng.standard_normal((NM, 5, 96, 2)).astype(np.float32)
    band = tdfn._consts(torch.device("cpu"))["bin_band"].numpy()
    y = np.empty_like(x)
    assert host_lib.host_dfn_spec_synth(_ptr(x), _ptr(gains), _ptr(coefs), _ptr(hist),
                                        _ptr(band), atten, beta, _ptr(y), NM) == 0
    yp = tdfn.dfn_spec_synth_plain(torch.as_tensor(x), torch.as_tensor(gains),
                                   torch.as_tensor(coefs), torch.as_tensor(hist), atten,
                                   beta).numpy()
    np.testing.assert_allclose(y, yp, atol=1e-6 * np.abs(yp).max())
