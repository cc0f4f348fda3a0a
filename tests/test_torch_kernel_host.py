"""Host C++ check of the ``biquad_cascade``, ``deesser_scan``,
``compressor_scan`` and ``gate_scan`` CUDA sources.

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
differ by an ulp at a threshold test. Needs ``g++``; without it the tests
skip with a reason.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from audioforge_tpu_torch.ops import biquad as tbq
from audioforge_tpu_torch.ops import compressor as tcomp
from audioforge_tpu_torch.ops import deesser as tdes
from audioforge_tpu_torch.ops import gate as tgate

N, T, FS = 3, 480, 48000.0
CHUNKS = [T, 128]
CSRC = Path(tbq.__file__).resolve().parents[1] / "csrc"

RUNNER = r"""
#include <algorithm>
#include <vector>
#include "biquad_cascade.cu"
#include "compressor_scan.cu"
#include "deesser_scan.cu"
#include "gate_scan.cu"

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

// Weights n / d for which bq_quotient and the division differ, over every
// integer d in [1, max_d] and n in [1, d + extra].
extern "C" long long host_quotient_mismatches(int max_d, int extra) {
    long long bad = 0;
    for (int d = 1; d <= max_d; ++d) {
        const double dd = d, rcp = 1.0 / dd;
        for (int n = 1; n <= d + extra; ++n)
            bad += bq_quotient((double)n, dd, rcp) != (double)n / dd;
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
"""

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The four kernel sources built for the host behind the runner."""
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
